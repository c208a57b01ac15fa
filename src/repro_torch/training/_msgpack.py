"""The subset of MessagePack (https://msgpack.org, the format spec) that
checkpoint files use: maps, strings, binary, integers and arrays, plus nil
and booleans. ``pack`` writes what ``msgpack.packb(obj, use_bin_type=True)``
writes, byte for byte: the smallest encoding of each int, str 8 for 32-255
byte strings, bin for ``bytes``. ``unpack`` reads those, as
``msgpack.unpackb(data, raw=False)`` does (str as ``str``, bin as a
``memoryview`` into ``data`` rather than a copy). The machines that run the
port need no msgpack package for it.

Binary payloads are bin 32 at most: a leaf over 4 GiB - 1 byte cannot be
written, here as in msgpack (both raise ``ValueError``)."""

from __future__ import annotations

import struct
from typing import Any, Callable, Mapping, Tuple

_INTS = ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"), (0xFFFFFFFF, 0xCE, ">I"),
         (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q"))
_NEG = ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"), (-0x80000000, 0xD2, ">i"),
        (-0x8000000000000000, 0xD3, ">q"))


def _head(n: int, fix: int, fix_max: int, wide: Tuple[Tuple[int, int, str], ...]) -> bytes:
    """The type byte (and length) of a str, bin, array or map of ``n`` items."""
    if fix_max and n <= fix_max:
        return bytes([fix | n])
    for limit, code, fmt in wide:
        if n <= limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} is too large")


_STR = ((0xFF, 0xD9, ">B"), (0xFFFF, 0xDA, ">H"), (0xFFFFFFFF, 0xDB, ">I"))
_BIN = ((0xFF, 0xC4, ">B"), (0xFFFF, 0xC5, ">H"), (0xFFFFFFFF, 0xC6, ">I"))
_ARRAY = ((0xFFFF, 0xDC, ">H"), (0xFFFFFFFF, 0xDD, ">I"))
_MAP = ((0xFFFF, 0xDE, ">H"), (0xFFFFFFFF, 0xDF, ">I"))


def pack(obj: Any, write: Callable[[Any], Any]) -> None:
    """Write ``obj`` through ``write`` (a file's ``write``); a binary payload
    (``bytes``, or a ``memoryview``, e.g. of a numpy array) is handed on as
    it is, never copied."""
    if obj is None:
        write(b"\xc0")
    elif obj is True or obj is False:
        write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        write(_int(obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        write(_head(len(data), 0xA0, 31, _STR))
        write(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = memoryview(obj).nbytes
        write(_head(n, 0, 0, _BIN))
        write(obj)
    elif isinstance(obj, (list, tuple)):
        write(_head(len(obj), 0x90, 15, _ARRAY))
        for v in obj:
            pack(v, write)
    elif isinstance(obj, Mapping):
        write(_head(len(obj), 0x80, 15, _MAP))
        for k, v in obj.items():
            pack(k, write)
            pack(v, write)
    else:
        raise TypeError(f"msgpack: cannot serialize {type(obj).__name__}")


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -0x20 <= v < 0:
        return struct.pack(">b", v)
    for limit, code, fmt in _INTS if v > 0 else _NEG:
        if (v > 0 and v <= limit) or (v < 0 and v >= limit):
            return bytes([code]) + struct.pack(fmt, v)
    raise OverflowError(f"msgpack: integer {v} out of range")


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_LEN = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xC4: ">B", 0xC5: ">H", 0xC6: ">I",
        0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}


def unpack(data: Any) -> Any:
    """The one object ``data`` (a bytes-like object) holds."""
    view = memoryview(data).cast("B")
    obj, end = _read(view, 0)
    if end != len(view):
        raise ValueError(f"msgpack: {len(view) - end} extra bytes")
    return obj


def _read(v: memoryview, i: int) -> Tuple[Any, int]:
    t = v[i]
    i += 1
    if t < 0x80:
        return t, i
    if t >= 0xE0:
        return t - 0x100, i
    if t in _FIXED:
        fmt = _FIXED[t]
        n = struct.calcsize(fmt)
        return struct.unpack_from(fmt, v, i)[0], i + n
    if t == 0xC0:
        return None, i
    if t in (0xC2, 0xC3):
        return t == 0xC3, i
    if 0xA0 <= t <= 0xBF:
        n, kind = t & 0x1F, "str"
    elif 0x90 <= t <= 0x9F:
        n, kind = t & 0x0F, "array"
    elif 0x80 <= t <= 0x8F:
        n, kind = t & 0x0F, "map"
    elif t in _LEN:
        fmt = _LEN[t]
        n = struct.unpack_from(fmt, v, i)[0]
        i += struct.calcsize(fmt)
        kind = ("str" if t in (0xD9, 0xDA, 0xDB) else "bin" if t in (0xC4, 0xC5, 0xC6)
                else "array" if t in (0xDC, 0xDD) else "map")
    else:
        raise ValueError(f"msgpack: type byte 0x{t:02x} is not in the subset")
    if kind == "str":
        return str(v[i:i + n], "utf-8"), i + n
    if kind == "bin":
        return v[i:i + n], i + n
    if kind == "array":
        out = []
        for _ in range(n):
            x, i = _read(v, i)
            out.append(x)
        return out, i
    out = {}
    for _ in range(n):
        k, i = _read(v, i)
        out[k], i = _read(v, i)
    return out, i
