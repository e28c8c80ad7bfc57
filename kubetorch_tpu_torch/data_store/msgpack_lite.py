"""A minimal MessagePack encoder/decoder for the blob headers and delta
plans of the packed-array format.

The JAX package writes those headers with ``msgpack.packb`` and reads them
with ``msgpack.unpackb``; the port must read and write the same bytes
without the ``msgpack`` package. :func:`packb` produces what
``msgpack.packb`` produces with its defaults (the smallest integer form,
float64 for floats, str and bin types kept apart, tuples as arrays), and
:func:`unpackb` reads it back with ``msgpack.unpackb``'s defaults
(``raw=False``, lists for arrays). Types: None, bool, int (64-bit), float,
str, bytes, list, tuple and dict.
"""

from __future__ import annotations

import struct
from typing import Any, List, Tuple


def _pack_into(obj: Any, out: List[bytes]) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        out.append(_pack_int(obj))
    elif isinstance(obj, float):
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        n = len(data)
        if n < 32:
            out.append(bytes([0xA0 | n]))
        elif n < 1 << 8:
            out.append(b"\xd9" + struct.pack(">B", n))
        elif n < 1 << 16:
            out.append(b"\xda" + struct.pack(">H", n))
        else:
            out.append(b"\xdb" + struct.pack(">I", n))
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        n = len(data)
        if n < 1 << 8:
            out.append(b"\xc4" + struct.pack(">B", n))
        elif n < 1 << 16:
            out.append(b"\xc5" + struct.pack(">H", n))
        else:
            out.append(b"\xc6" + struct.pack(">I", n))
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        n = len(obj)
        if n < 16:
            out.append(bytes([0x90 | n]))
        elif n < 1 << 16:
            out.append(b"\xdc" + struct.pack(">H", n))
        else:
            out.append(b"\xdd" + struct.pack(">I", n))
        for item in obj:
            _pack_into(item, out)
    elif isinstance(obj, dict):
        n = len(obj)
        if n < 16:
            out.append(bytes([0x80 | n]))
        elif n < 1 << 16:
            out.append(b"\xde" + struct.pack(">H", n))
        else:
            out.append(b"\xdf" + struct.pack(">I", n))
        for key, value in obj.items():
            _pack_into(key, out)
            _pack_into(value, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r}")


def _pack_int(v: int) -> bytes:
    if 0 <= v < 128:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, lim in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < lim:
                return bytes([code]) + struct.pack(fmt, v)
    else:
        for code, fmt, lim in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                               (0xD2, ">i", 1 << 31), (0xD3, ">q", 1 << 63)):
            if v >= -lim:
                return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"integer {v} does not fit 64 bits")


def packb(obj: Any) -> bytes:
    """``obj`` as MessagePack bytes."""
    out: List[bytes] = []
    _pack_into(obj, out)
    return b"".join(out)


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
          0xCA: ">f", 0xCB: ">d"}


def _unpack(mv: memoryview, i: int) -> Tuple[Any, int]:
    b = mv[i]
    i += 1
    if b < 0x80:
        return b, i
    if b >= 0xE0:
        return b - 0x100, i
    if 0x80 <= b <= 0x8F:
        return _unpack_map(mv, i, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _unpack_array(mv, i, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return str(mv[i:i + n], "utf-8"), i + n
    if b == 0xC0:
        return None, i
    if b == 0xC2:
        return False, i
    if b == 0xC3:
        return True, i
    if b in _FIXED:
        fmt = _FIXED[b]
        size = struct.calcsize(fmt)
        return struct.unpack(fmt, mv[i:i + size])[0], i + size
    for codes, kind in (((0xD9, 0xDA, 0xDB), "str"),
                        ((0xC4, 0xC5, 0xC6), "bin"),
                        ((0xDC, 0xDD), "array"), ((0xDE, 0xDF), "map")):
        if b in codes:
            width = {0: 1, 1: 2, 2: 4}[codes.index(b)
                                        + (1 if kind in ("array", "map")
                                           else 0)]
            n = int.from_bytes(mv[i:i + width], "big")
            i += width
            if kind == "str":
                return str(mv[i:i + n], "utf-8"), i + n
            if kind == "bin":
                return bytes(mv[i:i + n]), i + n
            if kind == "array":
                return _unpack_array(mv, i, n)
            return _unpack_map(mv, i, n)
    raise ValueError(f"unsupported MessagePack type byte 0x{b:02x}")


def _unpack_array(mv: memoryview, i: int, n: int) -> Tuple[list, int]:
    out = []
    for _ in range(n):
        item, i = _unpack(mv, i)
        out.append(item)
    return out, i


def _unpack_map(mv: memoryview, i: int, n: int) -> Tuple[dict, int]:
    out = {}
    for _ in range(n):
        key, i = _unpack(mv, i)
        if not isinstance(key, (str, bytes)):
            raise ValueError(f"{type(key).__name__} is not allowed as a "
                             f"map key")
        out[key], i = _unpack(mv, i)
    return out, i


def unpackb(data) -> Any:
    """The object MessagePack ``data`` holds; raises ``ValueError`` when
    the bytes hold more or less than one object."""
    mv = memoryview(data).cast("B")
    try:
        obj, end = _unpack(mv, 0)
    except (IndexError, struct.error):
        raise ValueError("truncated MessagePack data") from None
    if end != len(mv):
        raise ValueError(f"{len(mv) - end} extra bytes after the "
                         f"MessagePack object")
    return obj
