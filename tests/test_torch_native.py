"""The port's C++ host XOF (``janus_tpu_torch/native.py``) against its
pure Python sponge and against the JAX package's native library
(``janus_tpu/native``): byte-equal streams and field expansions for Field64
and Field128, the pure path for any other modulus, and a counted fallback
when the library is switched off."""

import importlib

import pytest

from janus_tpu import native as jax_native
from janus_tpu.xof import XofTurboShake128 as JaxXof
from janus_tpu_torch import native
from janus_tpu_torch.fields import Field64, Field128
from janus_tpu_torch.xof import Xof, XofTurboShake128, turboshake128

pytestmark = pytest.mark.skipif(native.load() is None, reason="no C++ compiler here")

SEED = bytes(reversed(range(16)))
DST = b"\x08\x00\x00\x00\x00\x03\x00\x01"


@pytest.mark.parametrize("msg_len,out_len", [(0, 1), (167, 168), (169, 400), (500, 16)])
def test_hash_matches_python_and_jax(msg_len, out_len):
    msg = bytes((i * 7 + msg_len) % 256 for i in range(msg_len))
    got = native.turboshake128(msg, 0x1F, out_len)
    assert got == turboshake128(msg, 0x1F, out_len) == jax_native.turboshake128(msg, 0x1F, out_len)


def test_xof_stream_matches_python_and_jax():
    want = XofTurboShake128(SEED, DST, b"binder").next(1000)
    assert native.xof_stream(SEED, DST, b"binder", 1000) == want == jax_native.xof_stream(SEED, DST, b"binder", 1000)


@pytest.mark.parametrize("field", [Field64, Field128])
@pytest.mark.parametrize("length", [1, 7, 333, 4096])
def test_expand_into_vec_matches_pure_path_and_jax(field, length):
    """The served path (native) equals the pure sponge and both JAX paths."""
    got = XofTurboShake128.expand_into_vec(field, SEED, DST, b"nv", length)
    assert got == XofTurboShake128(SEED, DST, b"nv").next_vec(field, length)
    from janus_tpu.fields import Field64 as J64, Field128 as J128

    jfield = J64 if field is Field64 else J128
    assert got == JaxXof.expand_into_vec(jfield, SEED, DST, b"nv", length)
    assert got == jax_native.next_vec(SEED, DST, b"nv", field.ENCODED_SIZE, length)


def test_native_path_engaged_and_other_moduli_pure(monkeypatch):
    """Field64/Field128 never reach the pure sponge; a third 8-byte modulus
    must (the C++ sampler hardcodes its bounds), and is not a fallback."""
    before = native.fallbacks()
    calls = []
    orig = Xof.next_vec

    def spy(self, field, length):
        calls.append(field)
        return orig(self, field, length)

    monkeypatch.setattr(Xof, "next_vec", spy)
    XofTurboShake128.expand_into_vec(Field128, b"\x07" * 16, DST, b"x", 5)
    XofTurboShake128.expand_into_vec(Field64, b"\x07" * 16, DST, b"x", 5)
    assert calls == []

    class Field61(Field64):
        MODULUS = 2**61 - 1

    out = XofTurboShake128.expand_into_vec(Field61, b"\x07" * 16, DST, b"x", 9)
    assert calls == [Field61] and all(x < Field61.MODULUS for x in out)
    assert native.fallbacks() == before
    with pytest.raises(ValueError):  # a short seed raises as on the pure path
        XofTurboShake128.expand_into_vec(Field64, b"", DST, b"x", 1)


def test_switched_off_counts_fallbacks(monkeypatch):
    """With ``JANUS_TPU_TORCH_NATIVE=0`` (read by the first ``load`` after a
    reload, which forgets the loaded library) the library stays unloaded
    and each Field64/Field128 expansion counts."""
    monkeypatch.setenv("JANUS_TPU_TORCH_NATIVE", "0")
    importlib.reload(native)
    try:
        assert native.load() is None
        want = XofTurboShake128(SEED, DST, b"off").next_vec(Field128, 20)
        assert XofTurboShake128.expand_into_vec(Field128, SEED, DST, b"off", 20) == want
        assert native.fallbacks() == 1
    finally:
        monkeypatch.delenv("JANUS_TPU_TORCH_NATIVE")
        importlib.reload(native)
    assert native.load() is not None and native.fallbacks() == 0


def test_build_dir_is_settable_and_shared(tmp_path, monkeypatch):
    """``_build.set_build_dir`` moves both the kernels' and the host XOF's
    libraries; a cold process builds by a temporary name and renames."""
    from janus_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", _build.BUILD_DIR)
    _build.set_build_dir(tmp_path / "shared")
    importlib.reload(native)
    try:
        assert native.load() is not None
        built = list((tmp_path / "shared").iterdir())
        assert built == [native.library_path()] and built[0].name.startswith("libjanusts-")
        assert _build.library_path("keccak").parent == tmp_path / "shared"
    finally:
        importlib.reload(native)
