"""MessagePack encoder/decoder for the subset iNGP snapshots use.

Snapshots (io/snapshot.py) are MessagePack maps of strings, numbers,
booleans, nil, arrays and binary blobs (the fp16 parameter and density
grid buffers). This module covers exactly those families — map, array,
str, bin, int, float, bool, nil — in every width the format defines, so
files written by other MessagePack libraries decode, and files written
here are byte-identical to `msgpack.packb(doc, use_bin_type=True)`.
Extension types are rejected.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["packb", "unpackb"]


# ---------------------------------------------------------------------------
# Encoding
# ---------------------------------------------------------------------------

def _pack_int(n: int, out: list):
    if 0 <= n < 0x80:
        out.append(struct.pack("B", n))
    elif -32 <= n < 0:
        out.append(struct.pack("b", n))
    elif n >= 0:
        for limit, code, fmt in ((0xFF, 0xCC, ">BB"), (0xFFFF, 0xCD, ">BH"),
                                 (0xFFFFFFFF, 0xCE, ">BI"),
                                 (0xFFFFFFFFFFFFFFFF, 0xCF, ">BQ")):
            if n <= limit:
                out.append(struct.pack(fmt, code, n))
                return
        raise OverflowError(f"integer {n} does not fit MessagePack")
    else:
        for limit, code, fmt in ((-0x80, 0xD0, ">Bb"), (-0x8000, 0xD1, ">Bh"),
                                 (-0x80000000, 0xD2, ">Bi"),
                                 (-0x8000000000000000, 0xD3, ">Bq")):
            if n >= limit:
                out.append(struct.pack(fmt, code, n))
                return
        raise OverflowError(f"integer {n} does not fit MessagePack")


def _pack_len(n: int, fix_base: int, fix_max: int, codes, out: list):
    """Length header: fix form when n <= fix_max, else the 8/16/32-bit
    forms in `codes` (None where the family has no such width)."""
    if fix_base is not None and n <= fix_max:
        out.append(struct.pack("B", fix_base | n))
        return
    for limit, code, fmt in zip((0xFF, 0xFFFF, 0xFFFFFFFF), codes,
                                (">BB", ">BH", ">BI")):
        if code is not None and n <= limit:
            out.append(struct.pack(fmt, code, n))
            return
    raise OverflowError(f"length {n} does not fit MessagePack")


def _pack(obj, out: list):
    if obj is None:
        out.append(b"\xc0")
    elif obj is True or obj is False or isinstance(obj, np.bool_):
        out.append(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, (int, np.integer)):
        _pack_int(int(obj), out)
    elif isinstance(obj, (float, np.floating)):
        out.append(struct.pack(">Bd", 0xCB, float(obj)))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), None, -1, (0xC4, 0xC5, 0xC6), out)
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(
            f"cannot serialize {type(obj).__name__} to MessagePack")


def packb(obj) -> bytes:
    """Serialize `obj` (dict/list/tuple/str/bytes/int/float/bool/None)."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------

# fixed-width scalars: code -> (struct format, size)
_SCALARS = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
# length-prefixed families: code -> (kind, length format, size)
_SIZED = {
    0xC4: ("bin", ">B", 1), 0xC5: ("bin", ">H", 2), 0xC6: ("bin", ">I", 4),
    0xD9: ("str", ">B", 1), 0xDA: ("str", ">H", 2), 0xDB: ("str", ">I", 4),
    0xDC: ("array", ">H", 2), 0xDD: ("array", ">I", 4),
    0xDE: ("map", ">H", 2), 0xDF: ("map", ">I", 4),
}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("truncated MessagePack data")
        chunk = self.data[self.pos:end]
        self.pos = end
        return chunk

    def value(self):
        code = self.take(1)[0]
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return self.map(code & 0x0F)
        if 0x90 <= code <= 0x9F:
            return [self.value() for _ in range(code & 0x0F)]
        if 0xA0 <= code <= 0xBF:
            return str(self.take(code & 0x1F), "utf-8")
        if code == 0xC0:
            return None
        if code in (0xC2, 0xC3):
            return code == 0xC3
        if code in _SCALARS:
            fmt, size = _SCALARS[code]
            return struct.unpack(fmt, self.take(size))[0]
        if code in _SIZED:
            kind, fmt, size = _SIZED[code]
            n = struct.unpack(fmt, self.take(size))[0]
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return str(self.take(n), "utf-8")
            if kind == "array":
                return [self.value() for _ in range(n)]
            return self.map(n)
        raise ValueError(f"unsupported MessagePack type byte 0x{code:02x}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(data: bytes):
    """Decode one MessagePack object; str as str, bin as bytes, arrays as
    lists, maps as dicts (keys of any decoded type)."""
    r = _Reader(data)
    obj = r.value()
    if r.pos != len(r.data):
        raise ValueError("extra data after MessagePack object")
    return obj
