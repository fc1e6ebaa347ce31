"""TLS-syntax codec primitives (network byte order, length-prefixed opaques).

The analog of ``prio::codec``'s Encode/Decode traits consumed by the reference
wire types (reference: messages/src/lib.rs:11-17).  Messages implement
``encode(w)`` / ``decode(cls, r)`` against these primitives; `get_encoded` /
`get_decoded` mirror the Rust helper methods and enforce full consumption.
"""

from __future__ import annotations

from typing import Callable, List, TypeVar

T = TypeVar("T")


class CodecError(Exception):
    pass


class Encoder:
    def __init__(self) -> None:
        self._parts: List[bytes] = []

    def write(self, data: bytes) -> None:
        self._parts.append(data)

    def u8(self, v: int) -> None:
        self.write(v.to_bytes(1, "big"))

    def u16(self, v: int) -> None:
        self.write(v.to_bytes(2, "big"))

    def u32(self, v: int) -> None:
        self.write(v.to_bytes(4, "big"))

    def u64(self, v: int) -> None:
        self.write(v.to_bytes(8, "big"))

    def fixed(self, data: bytes, size: int) -> None:
        if len(data) != size:
            raise CodecError(f"fixed field expected {size} bytes, got {len(data)}")
        self.write(data)

    def opaque_u16(self, data: bytes) -> None:
        if len(data) >= 1 << 16:
            raise CodecError("opaque too long for u16 prefix")
        self.u16(len(data))
        self.write(data)

    def opaque_u32(self, data: bytes) -> None:
        if len(data) >= 1 << 32:
            raise CodecError("opaque too long for u32 prefix")
        self.u32(len(data))
        self.write(data)

    def items_u16(self, items, encode_item: Callable) -> None:
        """Encode a u16-length-prefixed vector (length in bytes, not count)."""
        body = Encoder()
        for item in items:
            encode_item(body, item)
        self.opaque_u16(body.take())

    def items_u32(self, items, encode_item: Callable) -> None:
        body = Encoder()
        for item in items:
            encode_item(body, item)
        self.opaque_u32(body.take())

    def take(self) -> bytes:
        return b"".join(self._parts)


class Decoder:
    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0

    def remaining(self) -> int:
        return len(self._data) - self._pos

    def read(self, n: int) -> bytes:
        if self.remaining() < n:
            raise CodecError("unexpected end of buffer")
        out = self._data[self._pos : self._pos + n]
        self._pos += n
        return out

    def u8(self) -> int:
        return self.read(1)[0]

    def u16(self) -> int:
        return int.from_bytes(self.read(2), "big")

    def u32(self) -> int:
        return int.from_bytes(self.read(4), "big")

    def u64(self) -> int:
        return int.from_bytes(self.read(8), "big")

    def opaque_u16(self) -> bytes:
        return self.read(self.u16())

    def opaque_u32(self) -> bytes:
        return self.read(self.u32())

    def items_u16(self, decode_item: Callable[["Decoder"], T]) -> List[T]:
        sub = Decoder(self.opaque_u16())
        out: List[T] = []
        while sub.remaining():
            out.append(decode_item(sub))
        return out

    def items_u32(self, decode_item: Callable[["Decoder"], T]) -> List[T]:
        sub = Decoder(self.opaque_u32())
        out: List[T] = []
        while sub.remaining():
            out.append(decode_item(sub))
        return out

    def finish(self) -> None:
        if self.remaining():
            raise CodecError(f"{self.remaining()} trailing bytes")


class Message:
    """Base for wire messages: subclasses define encode(w) and _decode(r)."""

    def encode(self, w: Encoder) -> None:
        raise NotImplementedError

    @classmethod
    def _decode(cls, r: Decoder):
        raise NotImplementedError

    def get_encoded(self) -> bytes:
        w = Encoder()
        self.encode(w)
        return w.take()

    @classmethod
    def get_decoded(cls, data: bytes, *args, **kwargs):
        r = Decoder(data)
        out = cls._decode(r, *args, **kwargs)
        r.finish()
        return out
