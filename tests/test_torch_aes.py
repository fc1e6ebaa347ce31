"""The port's AES for the Poplar1 walk: ``ops/aes.py`` (PyTorch, here on
CPU tensors) against the FIPS-197 appendix C.1 vector, the port's numpy
``SoftAes128Ecb`` and the JAX package's ``encrypt_blocks_multikey``; the
host encryptor; and the card walk with no card, which raises."""

import numpy as np
import pytest
import torch

from janus_tpu_torch.ops import aes
from janus_tpu_torch.utils import softaes

FIPS_KEY = bytes(range(16))
FIPS_PLAIN = bytes.fromhex("00112233445566778899aabbccddeeff")
FIPS_CIPHER = bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")


def _fips_on_cpu_tensors() -> bytes:
    rk = aes.to_device_bytes(aes.expand_keys([FIPS_KEY]), "cpu")
    blk = aes.to_device_bytes(np.frombuffer(FIPS_PLAIN, dtype=np.uint8).reshape(1, 1, 16), "cpu")
    return aes.encrypt_blocks_multikey(rk, blk).numpy().astype(np.uint8).tobytes()


def test_fips197_c1_on_cpu_tensors():
    assert _fips_on_cpu_tensors() == FIPS_CIPHER
    assert softaes.aes128_ecb_encryptor(FIPS_KEY).update(FIPS_PLAIN) == FIPS_CIPHER


@pytest.mark.parametrize("reports,blocks", [(1, 1), (5, 7), (3, 64)])
def test_multikey_matches_soft_aes(reports, blocks):
    """Random keys, one a report: the tensor AES, the numpy multikey AES
    and a per-report ``SoftAes128Ecb`` agree byte for byte."""
    rng = np.random.default_rng(reports * 100 + blocks)
    keys = [rng.bytes(16) for _ in range(reports)]
    blk = rng.integers(0, 256, (reports, blocks, 16), dtype=np.uint8)
    rk = aes.expand_keys(keys)
    got = aes.encrypt_blocks_multikey(aes.to_device_bytes(rk, "cpu"), aes.to_device_bytes(blk, "cpu"))
    assert got.dtype == torch.int64
    got = got.numpy().astype(np.uint8)
    assert np.array_equal(got, softaes.encrypt_blocks_multikey(rk, blk))
    for b, k in enumerate(keys):
        assert got[b].tobytes() == softaes.SoftAes128Ecb(k).update(blk[b].tobytes())


def test_multikey_matches_jax_kernel():
    """One shape against ``janus_tpu/ops/aes_jax.encrypt_blocks_multikey``."""
    from janus_tpu.ops.aes_jax import encrypt_blocks_multikey as jax_multikey

    rng = np.random.default_rng(7)
    keys = [rng.bytes(16) for _ in range(4)]
    blk = rng.integers(0, 256, (4, 8, 16), dtype=np.uint8)
    rk = aes.expand_keys(keys)
    want = np.asarray(jax_multikey(rk, blk))
    got = aes.encrypt_blocks_multikey(aes.to_device_bytes(rk, "cpu"), aes.to_device_bytes(blk, "cpu"))
    assert np.array_equal(got.numpy().astype(np.uint8), want)


def test_poplar_backend_seam():
    """The host encryptor is the oracle's and the reference walk's, both
    ways it can be built (`cryptography` or the numpy soft AES); the walk
    that serves runs on the card and, with no card, raises rather than
    degrade to the host."""
    soft = softaes.SoftAes128Ecb(FIPS_KEY)
    assert softaes.aes128_ecb_encryptor(FIPS_KEY).update(FIPS_PLAIN * 3) == soft.update(FIPS_PLAIN * 3)
    if not torch.cuda.is_available():
        from janus_tpu_torch.ops.poplar1_batch import BatchedPoplar1
        from janus_tpu_torch.vdaf.poplar1 import Poplar1

        with pytest.raises(RuntimeError, match="CUDA card"):
            BatchedPoplar1(Poplar1(4), device="cuda")


def test_wrong_table_fails_the_anchor(monkeypatch):
    """The FIPS anchor runs at a device's first use and raises on a wrong
    table."""
    bad = softaes._SBOX.copy()
    bad[0x42] ^= 1
    monkeypatch.setattr(aes, "_SBOX", bad)
    monkeypatch.setattr(aes, "_TABLES", {})
    with pytest.raises(AssertionError):
        _fips_on_cpu_tensors()
