"""Image files: a PNG codec on `zlib` and numpy, Pillow for the rest.

PNG carries every image the system reads or writes itself (training
frames, depth maps, glTF textures, rendered frames, the bench golden),
so those paths need nothing beyond the standard library and numpy.
Other formats (JPEG training images or textures, the viewer's JPEG
stream) go through Pillow, imported only when such a file appears.

Decoding covers non-interlaced PNGs of every color type (gray, RGB,
palette, gray+alpha, RGBA) and bit depth; encoding writes 8- or 16-bit
gray, gray+alpha, RGB or RGBA with no row filter.
"""

from __future__ import annotations

import io
import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # PNG color type -> samples


def _pil(what: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(
            f"{what} needs Pillow (PIL), which is not installed; PNG files "
            "are read and written without it") from e
    return Image


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, row_bytes: int, bpp: int):
    """Undo the per-row PNG filters -> (height, row_bytes) uint8.

    Each byte depends on its left neighbour (bpp bytes back), the byte
    above and the one above-left, so bytes are recovered one
    anti-diagonal of (row, pixel) at a time, all rows at once."""
    rows = raw.reshape(height, row_bytes + 1)
    ftype = rows[:, 0]
    if ftype.max() > 4:
        raise ValueError("bad PNG filter type")
    if not ftype.any():
        return rows[:, 1:].copy()
    width = row_bytes // bpp
    f = rows[:, 1:].reshape(height, width, bpp).astype(np.int32)
    out = np.zeros((height + 1, width + 1, bpp), np.int32)
    for k in range(height + width - 1):
        r = np.arange(max(0, k - width + 1), min(height, k + 1))
        c = k - r
        a = out[r + 1, c]
        b = out[r, c + 1]
        cc = out[r, c]
        ft = ftype[r][:, None]
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, cc)], 0)
        out[r + 1, c + 1] = (f[r, c] + pred) & 0xFF
    return out[1:, 1:].reshape(height, row_bytes).astype(np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, C) uint8 or uint16 array, C in 1..4 (palette
    images expand to RGB, or RGBA when they carry transparency)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    header = None
    idat = []
    palette = None
    trns = None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, _comp, _filt, interlace = header
    if interlace:
        raise ValueError("interlaced PNG is not supported")
    if ctype not in _CHANNELS:
        raise ValueError(f"bad PNG color type {ctype}")
    ch = _CHANNELS[ctype]
    bits = ch * depth
    row_bytes = (width * bits + 7) // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[:height * (row_bytes + 1)]
    px = _unfilter(raw, height, row_bytes, max(1, bits // 8))

    if depth == 16:
        img = px.view(">u2").astype(np.uint16).reshape(height, width, ch)
    elif depth == 8:
        img = px.reshape(height, width, ch)
    else:   # 1/2/4-bit gray or palette indices
        vals = np.unpackbits(px, axis=1).reshape(height, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        img = (vals * weights).sum(-1).astype(np.uint8)[:, :width, None]
        if ctype == 0:
            img = (img.astype(np.uint32) * 255 // ((1 << depth) - 1)
                   ).astype(np.uint8)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        idx = img[..., 0]
        rgb = palette[idx]
        if trns is not None:
            alpha = np.full(len(palette), 255, np.uint8)
            alpha[:len(trns)] = trns[:len(palette)]
            return np.concatenate([rgb, alpha[idx][..., None]], -1)
        return rgb
    return img


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """(H, W) or (H, W, C) uint8/uint16 array, C in 1..4 -> PNG bytes."""
    a = np.asarray(img)
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[2] not in (1, 2, 3, 4):
        raise ValueError(f"cannot write an image of shape {img.shape}")
    if a.dtype == np.uint8:
        depth = 8
    elif a.dtype == np.uint16:
        depth = 16
        a = a.astype(">u2")
    else:
        raise ValueError(f"PNG pixels must be uint8 or uint16, got {a.dtype}")
    h, w, ch = a.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = a.reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                         0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + chunk(b"IEND", b""))


# ---------------------------------------------------------------------------
# Any format
# ---------------------------------------------------------------------------

def _to_mode(img: np.ndarray, mode: str) -> np.ndarray:
    """Convert a decoded (H, W, C) image to 8-bit "RGB" or "RGBA"."""
    if img.dtype == np.uint16:
        img = (img >> 8).astype(np.uint8)
    ch = img.shape[2]
    rgb = img[..., :3] if ch >= 3 else np.repeat(img[..., :1], 3, axis=2)
    if mode == "RGB":
        return np.ascontiguousarray(rgb)
    alpha = (img[..., ch - 1:] if ch in (2, 4)
             else np.full(img.shape[:2] + (1,), 255, np.uint8))
    return np.concatenate([rgb, alpha], axis=2)


def decode_image(data: bytes, mode: str = None, name: str = "image"):
    """Image file bytes -> numpy array. mode=None keeps the file's own
    samples ((H, W) for one channel, else (H, W, C); uint8 or uint16);
    "RGB"/"RGBA" convert to 8-bit (H, W, 3/4)."""
    if data[:8] == PNG_SIGNATURE:
        img = decode_png(data)
        if mode is not None:
            return _to_mode(img, mode)
        return img[..., 0] if img.shape[2] == 1 else img
    ext = os.path.splitext(name)[1].lstrip(".").upper() or "non-PNG"
    pil = _pil(f"reading the {ext} image {name}").open(io.BytesIO(data))
    return np.asarray(pil.convert(mode) if mode else pil)


def read_image(path: str, mode: str = None) -> np.ndarray:
    """Read an image file; see decode_image."""
    with open(path, "rb") as f:
        return decode_image(f.read(), mode, name=path)


def write_image(path: str, img: np.ndarray):
    """Write a uint8/uint16 array; the format follows the extension
    (.png here, others through Pillow)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".png":
        with open(path, "wb") as f:
            f.write(encode_png(img))
        return
    Image = _pil(f"writing the {ext.lstrip('.').upper() or 'unnamed'} "
                 f"image {path}")
    Image.fromarray(np.asarray(img)).save(path)


def encode_jpeg(img: np.ndarray, quality: int = 85) -> bytes:
    """(H, W, 3) uint8 -> JPEG bytes (through Pillow)."""
    buf = io.BytesIO()
    _pil("JPEG encoding").fromarray(np.asarray(img)).save(
        buf, "JPEG", quality=quality)
    return buf.getvalue()
