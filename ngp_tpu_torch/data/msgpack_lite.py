"""A small msgpack codec, enough for snapshots (reference ``.ingp`` and the
port's own).

``unpackb`` decodes maps, arrays, str, bin, ints, floats, bool and nil the
way ``msgpack.unpackb(blob, raw=False, strict_map_key=False)`` does: bin as
``bytes``, str as ``str``, arrays as lists, maps as dicts. Extension types
raise. ``packb`` encodes None, bool, int (up to 64 bits), float (as
float64), str, bytes, lists, tuples and dicts byte for byte as
``msgpack.packb(obj, use_bin_type=True)`` does: each in its smallest form,
maps in insertion order. Any other type raises ``TypeError``. The port
carries its own codec because the msgpack package is not a dependency it
can count on.
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


def _head(n: int, fix: int | None, fix_max: int, forms) -> bytes:
    """The header of a str, bin, array or map of length ``n``: the fixed
    form ``fix | n`` below ``fix_max``, else the first (limit, type byte,
    length format) of ``forms`` that holds ``n``."""
    if fix is not None and n < fix_max:
        return bytes((fix | n,))
    for limit, byte, fmt in forms:
        if n < limit:
            return bytes((byte,)) + struct.pack(fmt, n)
    raise MsgpackError(f"object of length {n} is too long for msgpack")


_STR = ((1 << 8, 0xD9, ">B"), (1 << 16, 0xDA, ">H"), (1 << 32, 0xDB, ">I"))
_BIN = ((1 << 8, 0xC4, ">B"), (1 << 16, 0xC5, ">H"), (1 << 32, 0xC6, ">I"))
_ARRAY = ((1 << 16, 0xDC, ">H"), (1 << 32, 0xDD, ">I"))
_MAP = ((1 << 16, 0xDE, ">H"), (1 << 32, 0xDF, ">I"))
_UINT = ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"), (1 << 32, 0xCE, ">I"),
         (1 << 64, 0xCF, ">Q"))
_INT = ((-(1 << 7), 0xD0, ">b"), (-(1 << 15), 0xD1, ">h"), (-(1 << 31), 0xD2, ">i"),
        (-(1 << 63), 0xD3, ">q"))


def _pack_int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes((v,))
    if -32 <= v < 0:
        return bytes((v & 0xFF,))
    forms = _UINT if v > 0 else _INT
    for limit, byte, fmt in forms:
        if (v < limit) if v > 0 else (v >= limit):
            return bytes((byte,)) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit in 64 bits")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif isinstance(obj, bool):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        out.append(_head(len(data), 0xA0, 32, _STR))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        out.append(_head(len(data), None, 0, _BIN))
        out.append(data)
    elif isinstance(obj, dict):
        out.append(_head(len(obj), 0x80, 16, _MAP))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        out.append(_head(len(obj), 0x90, 16, _ARRAY))
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """Encode ``obj`` as ``msgpack.packb(obj, use_bin_type=True)`` does."""
    out = []
    _pack(obj, out)
    return b"".join(out)
