"""A small msgpack decoder, enough for reference ``.ingp`` snapshots.

Decodes maps, arrays, str, bin, ints, floats, bool and nil the way
``msgpack.unpackb(blob, raw=False, strict_map_key=False)`` does: bin as
``bytes``, str as ``str``, arrays as lists, maps as dicts. Extension types
raise. The port carries its own decoder because the msgpack package is not
a dependency it can count on.
"""

from __future__ import annotations

import struct


class MsgpackError(ValueError):
    pass


_FIXED = {
    0xCA: ">f", 0xCB: ">d",
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
}
_LEN = {  # type byte -> (length format, kind)
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
}


class _Reader:
    def __init__(self, blob: bytes):
        self.buf = memoryview(blob)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise MsgpackError("truncated msgpack data")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.container("map", b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.container("array", b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.container("str", b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in _LEN:
            fmt, kind = _LEN[b]
            return self.container(kind, self.unpack(fmt))
        raise MsgpackError(f"unsupported msgpack type byte 0x{b:02x}")

    def container(self, kind: str, n: int):
        if kind == "bin":
            return bytes(self.take(n))
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "array":
            return [self.value() for _ in range(n)]
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(blob: bytes):
    """Decode one msgpack object from ``blob``; trailing bytes raise."""
    r = _Reader(blob)
    out = r.value()
    if r.pos != len(r.buf):
        raise MsgpackError(f"{len(r.buf) - r.pos} trailing bytes after object")
    return out
