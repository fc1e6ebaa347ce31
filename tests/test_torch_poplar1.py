"""Poplar1 in the port, held against the JAX package on the CPU: the IDPF
and ``Poplar1`` oracles byte for byte (shards, prepare states and shares,
the resident state codec), ``BatchedPoplar1`` on ``device="cpu"`` (the
card walk, and the host walk it is held against) against the JAX batch
and the oracles, the per-report XOFs
the batch runs over all its rows at once, and ``TField(Field255)`` — the
leaf level's sketch field — against ``JField(Field255)``."""

import os
import random

import numpy as np
import pytest
import torch

import janus_tpu.vdaf.poplar1 as jax_poplar1
from janus_tpu_torch.fields import Field255
from janus_tpu_torch.ops import poplar1_batch as PB
from janus_tpu_torch.ops.field import TField
from janus_tpu_torch.vdaf.backend import Poplar1Backend, make_backend
from janus_tpu_torch.vdaf.instances import vdaf_from_instance
from janus_tpu_torch.vdaf.poplar1 import Poplar1, Poplar1AggregationParam

VK = b"\x2a" * 16


def _reports(bits, n, seed):
    """``n`` reports sharded by the port and by the JAX package from the
    same seeds: (nonce, port public, port shares, jax public, jax shares,
    measurement)."""
    vdaf, jvdaf = Poplar1(bits), jax_poplar1.Poplar1(bits)
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        nonce, rand, m = rng.randbytes(16), rng.randbytes(vdaf.RAND_SIZE), rng.randrange(1 << bits)
        pub, shares = vdaf.shard(m, nonce, rand)
        jpub, jshares = jvdaf.shard(m, nonce, rand)
        out.append((nonce, pub, shares, jpub, jshares, m))
    return vdaf, jvdaf, out


def _params(level, prefixes):
    return Poplar1AggregationParam(level, prefixes), jax_poplar1.Poplar1AggregationParam(level, prefixes)


@pytest.mark.parametrize("bits", [4, 6])
def test_shard_and_prepare_match_the_jax_oracle(bits):
    """Same seeds: byte-equal public and input shares; at every level the
    port's prep_init states and shares encode as the JAX package's, each
    package decodes the other's, and the two-round ping-pong reaches the
    same prefix values, whose sum over the parties is 1 on the
    measurement's path and 0 elsewhere."""
    vdaf, jvdaf, rows = _reports(bits, 4, seed=bits)
    for nonce, pub, shares, jpub, jshares, _m in rows:
        assert vdaf.encode_public_share(pub) == jvdaf.encode_public_share(jpub)
        for a in (0, 1):
            enc = shares[a].encode(vdaf)
            assert enc == jshares[a].encode(jvdaf)
            assert vdaf.decode_input_share(a, enc).encode(vdaf) == enc
        assert vdaf.encode_public_share(vdaf.decode_public_share(vdaf.encode_public_share(pub))) == (
            vdaf.encode_public_share(pub)
        )
    for level in range(bits):
        prefixes = tuple(range(min(4, 1 << (level + 1))))
        ap, jap = _params(level, prefixes)
        assert vdaf.encode_agg_param(ap) == jvdaf.encode_agg_param(jap)
        for nonce, pub, shares, jpub, jshares, m in rows:
            got = [vdaf.prep_init(VK, a, ap, nonce, pub, shares[a]) for a in (0, 1)]
            want = [jvdaf.prep_init(VK, a, jap, nonce, jpub, jshares[a]) for a in (0, 1)]
            for (st, sh), (jst, jsh) in zip(got, want):
                assert sh.encode() == jsh.encode()
                enc = vdaf.ping_pong_encode_state(st)
                assert enc == jvdaf.ping_pong_encode_state(jst)
                assert jvdaf.ping_pong_encode_state(jvdaf.ping_pong_decode_state(enc)) == enc
                assert vdaf.ping_pong_encode_state(vdaf.ping_pong_decode_state(enc)) == enc
            msg = vdaf.ping_pong_prep_shares_to_prep(ap, [s for _st, s in got], round=0)
            assert msg == jvdaf.ping_pong_prep_shares_to_prep(jap, [s for _st, s in want], round=0)
            nxt = [vdaf.ping_pong_prep_next(st, msg) for st, _sh in got]
            sigma = [vdaf.ping_pong_decode_prep_share(n[2], round=1) for n in nxt]
            assert vdaf.ping_pong_prep_shares_to_prep(ap, sigma, round=1) == b""
            outs = [vdaf.ping_pong_prep_next(n[1], b"")[1] for n in nxt]
            field = vdaf.field_for_agg_param(ap)
            total = [field.add(x, y) for x, y in zip(*outs)]
            top = m >> (bits - 1 - level)
            assert total == [int(p == top) for p in prefixes]


def test_tampered_key_fails_the_sketch():
    vdaf, _jvdaf, rows = _reports(4, 1, seed=9)
    nonce, pub, shares, _jp, _js, _m = rows[0]
    shares[0].idpf_key = bytes(b ^ 0x5A for b in shares[0].idpf_key)
    ap, _ = _params(2, (0, 1, 2, 3, 4, 5, 6, 7))
    inits = [vdaf.prep_init(VK, a, ap, nonce, pub, shares[a]) for a in (0, 1)]
    msg = vdaf.ping_pong_prep_shares_to_prep(ap, [s for _st, s in inits], round=0)
    sigma = [vdaf.ping_pong_decode_prep_share(vdaf.ping_pong_prep_next(st, msg)[2], round=1) for st, _ in inits]
    with pytest.raises(Exception, match="sketch verification failed"):
        vdaf.ping_pong_prep_shares_to_prep(ap, sigma, round=1)


def test_instance_registry_and_backend_factory():
    vdaf = vdaf_from_instance({"type": "Poplar1", "bits": 16})
    assert isinstance(vdaf, Poplar1) and vdaf.bits == 16
    from janus_tpu_torch.vdaf.backend import device_path_label, device_supported
    from janus_tpu_torch.vdaf.prio3 import VdafError

    assert device_supported(vdaf) == (True, "")
    assert device_path_label(vdaf).startswith("poplar1-batch")
    backend = make_backend(vdaf, "cuda", device="cpu")
    assert isinstance(backend, Poplar1Backend) and backend.bp.device.type == "cpu"
    with pytest.raises(VdafError):
        make_backend(vdaf, "tpu", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(VdafError):
            make_backend(vdaf)


def test_batched_xof_rows_match_the_scalar_xof():
    """The batch's per-report XOF work, batched over the rows: the verify
    randomness at both fields equals ``Poplar1._verify_rands`` row by row,
    and a stream whose candidate is >= p is flagged (the scalar XOF then
    recomputes the row)."""
    vdaf, _jvdaf, rows = _reports(6, 5, seed=13)
    bp = PB.BatchedPoplar1(vdaf, device="cpu")
    vks = [bytes([i]) * 16 for i in range(5)]
    nonces = [r[0] for r in rows]
    for level, prefixes in ((2, (0, 3, 5)), (5, (1, 7, 40, 63))):
        ap, _ = _params(level, prefixes)
        tf = TField(vdaf.field_for_agg_param(ap))
        got = bp._verify_rands(vks, nonces, ap)
        assert [tf.from_limbs(g) for g in got] == [vdaf._verify_rands(vk, n, ap) for vk, n in zip(vks, nonces)]
    field = vdaf.field_for_agg_param(_params(2, (0,))[0])
    stream = np.zeros((2, 3 * field.ENCODED_SIZE), dtype=np.uint8)
    stream[1, 8:16] = np.frombuffer(field.MODULUS.to_bytes(8, "little"), dtype=np.uint8)  # candidate 1 = p
    _limbs, clean = PB._field_rows(field, stream, 3)
    assert clean.tolist() == [True, False]


def _assert_outcomes_equal(vdaf, jvdaf, got, want):
    assert len(got) == len(want)
    for (st, sh), (jst, jsh) in zip(got, want):
        assert sh.encode() == jsh.encode()
        assert vdaf.ping_pong_encode_state(st) == jvdaf.ping_pong_encode_state(jst)


@pytest.mark.parametrize("walk", ["host", "cuda"])
@pytest.mark.parametrize("level", [0, 2, 5])
def test_batch_matches_the_jax_oracle(walk, level):
    """The port's batch (on CPU tensors) gives the JAX oracle's states and
    shares at levels 0 and 2 (Field64) and the leaf (Field255), both
    parties: "cuda" is the card walk with rows of two verify keys in one
    walk, "host" the reference prepare through the host walk."""
    vdaf, jvdaf, rows = _reports(6, 10, seed=20 + level)
    prefixes = tuple(sorted({r[5] >> (5 - level) for r in rows} | {0}))
    ap, jap = _params(level, prefixes)
    bp = PB.BatchedPoplar1(vdaf, device="cpu")
    vk2 = b"\x33" * 16
    for a in (0, 1):
        reqs = [(VK, ap, [(r[0], r[1], r[2][a]) for r in rows[:6]]), (vk2, ap, [(r[0], r[1], r[2][a]) for r in rows[6:]])]
        if walk == "cuda":
            got = bp.prep_init_multi(a, reqs)
        else:
            got = [bp.prep_init_batch_host(vk, a, p, sub) for vk, p, sub in reqs]
        for (vk, _p, _rows), out, sub in zip(reqs, got, (rows[:6], rows[6:])):
            want = [jvdaf.prep_init(vk, a, jap, r[0], r[3], r[4][a]) for r in sub]
            _assert_outcomes_equal(vdaf, jvdaf, out, want)
    assert bp.oracle_recompute_rows == 0
    assert bp.sketch_readback_rows == (2 * len(rows) if walk == "cuda" else 0)


def test_walks_match_the_jax_batch():
    """The port's card walk and its host (reference) walk against the JAX
    package's host walk at every level of a 6-bit tree, the JAX card walk
    (``aes_jax``) at one, and the full JAX batch (host walk + JField
    sketch) at a Field64 level."""
    from janus_tpu.ops.poplar1_batch import BatchedPoplar1 as JaxBatch

    vdaf, jvdaf, rows = _reports(6, 8, seed=5)
    card = PB.BatchedPoplar1(vdaf, device="cpu")
    jhost = JaxBatch(jvdaf, poplar_backend="host")
    nonces = [r[0] for r in rows]
    for level in range(6):
        prefixes = sorted({r[5] >> (5 - level) for r in rows})
        for a in (0, 1):
            keys = [r[2][a].idpf_key for r in rows]
            want, want_ok = jhost.eval_batch(a, [r[3] for r in rows], keys, level, prefixes, nonces)
            for walk in (card.eval_batch_host, card.eval_batch):
                got, ok = walk(a, [r[1] for r in rows], keys, level, prefixes, nonces)
                assert got.tolist() == want.tolist() and ok.tolist() == want_ok.tolist(), (level, a)
    jcard = JaxBatch(jvdaf, poplar_backend="jax")
    keys = [r[2][1].idpf_key for r in rows]
    prefixes = sorted({r[5] >> 2 for r in rows})
    want, _ = jcard.eval_batch(1, [r[3] for r in rows], keys, 3, prefixes, nonces)
    got, _ = card.eval_batch(1, [r[1] for r in rows], keys, 3, prefixes, nonces)
    assert got.tolist() == want.tolist()
    ap, jap = _params(2, (1, 3, 6))
    for a in (0, 1):
        want = jhost.prep_init_batch(VK, a, jap, [(r[0], r[3], r[4][a]) for r in rows])
        got = card.prep_init_batch(VK, a, ap, [(r[0], r[1], r[2][a]) for r in rows])
        _assert_outcomes_equal(vdaf, jvdaf, got, want)


def test_rejected_candidate_rows_go_to_the_oracle(monkeypatch):
    """A row whose walk flags a rejected first candidate (``ok`` False) is
    prepared by the oracle, counted, and its resident row released."""
    vdaf, _jvdaf, rows = _reports(4, 4, seed=8)
    ap, _ = _params(3, (1, 5, 9))
    bp = PB.BatchedPoplar1(vdaf, device="cpu")
    real = bp._eval_batch_dev

    def flag_row_2(*args):
        y, ok = real(*args)
        ok[2] = False
        return y, ok

    monkeypatch.setattr(bp, "_eval_batch_dev", flag_row_2)
    from janus_tpu_torch.executor.accumulator import DeviceAccumulatorStore, ResidentRef

    store = DeviceAccumulatorStore()
    reports = [(r[0], r[1], r[2][0]) for r in rows]
    out = bp._prep_rows([VK] * 4, 0, ap, reports, retain_store=store)
    want = [vdaf.prep_init(VK, 0, ap, *rep) for rep in reports]
    assert bp.oracle_recompute_rows == 1
    assert isinstance(out[2][0].y_flat, list) and out[2][0].y_flat == want[2][0].y_flat
    assert all(isinstance(out[i][0].y_flat, ResidentRef) for i in (0, 1, 3))
    assert all(o[1].encode() == w[1].encode() for o, w in zip(out, want))
    fid = out[0][0].y_flat.flush_id
    assert store._flushes[fid].consumed == {2}


def test_tfield_field255_matches_jfield():
    """The leaf's sketch field: add, sub and the lazy and pairwise sums of
    TField(Field255) against JField(Field255) on edge and random values
    (eight limbs, R = 2^256); the Montgomery product and form against the
    integers (and the product against JField with RUN_SLOW=1)."""
    import jax.numpy as jnp

    from janus_tpu.fields import Field255 as JaxField255
    from janus_tpu.ops.field_jax import JField

    tf, jf = TField(Field255), JField(JaxField255)
    p = Field255.MODULUS
    rng = random.Random(255)
    a_vals = [0, 1, p - 1, p - 2, 2**32 - 1, 2**224, 2**254, 19] + [rng.randrange(p) for _ in range(8)]
    b_vals = [p - 1, p - 1, p - 1, 2, 2**32 + 1, 2**31, 2**254 + 5, p - 19] + [rng.randrange(p) for _ in range(8)]
    a, b = tf.to_limbs(a_vals), tf.to_limbs(b_vals)
    ta, tb = (torch.from_numpy(x.astype(np.int64)) for x in (a, b))
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pairs = {
        "add": (tf.add(ta, tb), jf.add(ja, jb)),
        "sub": (tf.sub(ta, tb), jf.sub(ja, jb)),
        "sum": (tf.sum(ta.reshape(1, 16, 8), axis=1), jf.sum(ja.reshape(1, 16, 8), axis=1)),
        "sum_short": (tf.sum(ta.reshape(4, 4, 8), axis=1), jf.sum(ja.reshape(4, 4, 8), axis=1)),
    }
    if os.environ.get("RUN_SLOW"):
        # XLA:CPU takes 8-25 s to compile JField's eight-limb product
        pairs["mont_mul"] = (tf.mont_mul(ta, tb), jf.mont_mul(ja, jb))
    for name, (got, want) in pairs.items():
        assert np.array_equal(got.numpy().astype(np.uint32), np.asarray(want)), name
    r_inv = pow(1 << 256, -1, p)
    assert tf.from_limbs(tf.mont_mul(ta, tb).numpy().astype(np.uint32)) == [x * y * r_inv % p for x, y in zip(a_vals, b_vals)]
    assert tf.from_limbs(tf.to_mont(ta).numpy().astype(np.uint32)) == [x * (1 << 256) % p for x in a_vals]
