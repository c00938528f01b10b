"""In-repo MessagePack and PNG codecs: agreement with the reference
libraries where installed, round trips, and the main path with neither
library importable."""

import io
import os
import sys

import numpy as np
import pytest

from nerf_glasses_tpu.io import images, messagepack

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED = os.path.join(ROOT, "assets", "trained", "trained_head_v6.msgpack")


# ---------------------------------------------------------------------------
# MessagePack
# ---------------------------------------------------------------------------

_VALUES = {
    "nil": None,
    "bools": [True, False],
    "fixints": [0, 1, 127, -1, -32],
    "int_widths": [128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
                   2 ** 64 - 1, -33, -128, -129, -32768, -32769,
                   -2 ** 31, -2 ** 31 - 1, -2 ** 63],
    "floats": [0.0, -1.5, 1e300, float("inf"), 3.14159],
    "str_widths": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
                   "e" * 65536, "unicodé ✓"],
    "bin_widths": [b"", b"\x00" * 255, b"\x01" * 256, b"\x02" * 65536],
    "array_widths": [list(range(15)), list(range(16)),
                     list(range(65536))],
    "map_widths": [{str(i): i for i in range(15)},
                   {str(i): i for i in range(16)},
                   {i: None for i in range(65536)}],
    "nested": {"a": [1, {"b": b"\x00\xff", "c": [None, True, 2.5]}],
               "snapshot": {"version": 1, "aabb": {"min": [0.0, 0.0, 0.0]}}},
}


@pytest.mark.parametrize("name", sorted(_VALUES))
def test_msgpack_round_trip(name):
    v = _VALUES[name]
    assert messagepack.unpackb(messagepack.packb(v)) == v


@pytest.mark.parametrize("name", sorted(_VALUES))
def test_msgpack_bytes_match_reference_library(name):
    msgpack = pytest.importorskip("msgpack")
    v = _VALUES[name]
    assert messagepack.packb(v) == msgpack.packb(v, use_bin_type=True)
    assert messagepack.unpackb(msgpack.packb(v, use_bin_type=True)) == \
        msgpack.unpackb(msgpack.packb(v, use_bin_type=True), raw=False,
                        strict_map_key=False)


def test_msgpack_decodes_single_float_and_tuples():
    # float32 (0xca) only appears in files written by other encoders
    assert messagepack.unpackb(b"\xca\x3f\xc0\x00\x00") == 1.5
    assert messagepack.unpackb(messagepack.packb((1, 2))) == [1, 2]


@pytest.mark.parametrize("data", [b"\xd4\x01\x00", b"\xc1", b"\xda\x00\x05ab",
                                  b"\x01\x02"])
def test_msgpack_rejects_ext_truncated_and_trailing(data):
    with pytest.raises(ValueError):
        messagepack.unpackb(data)


def test_msgpack_rejects_unknown_type():
    with pytest.raises(TypeError):
        messagepack.packb({"x": object()})


def test_trained_snapshot_decodes_like_reference_library():
    msgpack = pytest.importorskip("msgpack")
    with open(TRAINED, "rb") as f:
        data = f.read()
    ours = messagepack.unpackb(data)
    ref = msgpack.unpackb(data, raw=False, strict_map_key=False)
    assert ours == ref
    assert messagepack.packb(ours) == msgpack.packb(ref, use_bin_type=True)


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _img(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    hi = 256 if dtype == np.uint8 else 65536
    # smooth ramps plus noise: every PNG filter type wins some rows when
    # an adaptive encoder writes it
    yy, xx = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]),
                         indexing="ij")
    base = (xx * 7 + yy * 3) % hi
    if len(shape) == 3:
        base = base[..., None] + np.arange(shape[2]) * 11
    noise = rng.integers(0, 4, size=shape)
    return ((base + noise) % hi).astype(dtype)


_PNG_CASES = {
    "gray8": ((17, 23), np.uint8),
    "gray16": ((9, 31), np.uint16),
    "gray_alpha8": ((12, 5, 2), np.uint8),
    "rgb8": ((33, 41, 3), np.uint8),
    "rgba8": ((20, 19, 4), np.uint8),
    "rgb16": ((7, 13, 3), np.uint16),
}


@pytest.mark.parametrize("name", sorted(_PNG_CASES))
def test_png_round_trip(name):
    shape, dtype = _PNG_CASES[name]
    img = _img(shape, dtype)
    out = images.decode_png(images.encode_png(img))
    np.testing.assert_array_equal(out.reshape(img.shape), img)
    assert out.dtype == img.dtype


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P", "1",
                                  "I;16", "PA"])
def test_png_decodes_pillow_files(mode):
    """Files from another encoder (adaptive row filters, palettes, 1-bit
    and 16-bit samples) decode to what that library reads back."""
    Image = pytest.importorskip("PIL.Image")
    rgba = _img((29, 37, 4), np.uint8, seed=3)
    pil = Image.fromarray(rgba, "RGBA")
    if mode == "I;16":
        pil = Image.fromarray(_img((29, 37), np.uint16))
    elif mode == "P":
        pil = pil.convert("RGB").quantize(16)
    elif mode == "PA":
        pil = pil.convert("RGB").quantize(16)
        pil.info["transparency"] = 3
        mode = "P"
    else:
        pil = pil.convert(mode)
    buf = io.BytesIO()
    pil.save(buf, "PNG", optimize=mode in ("RGB", "RGBA"),
             **({"transparency": 3} if "transparency" in pil.info else {}))
    data = buf.getvalue()
    back = Image.open(io.BytesIO(data))
    if mode == "P":
        want = np.asarray(back.convert(
            "RGBA" if "transparency" in back.info else "RGB"))
        got = images.decode_png(data)
    elif mode == "1":
        want = np.asarray(back.convert("L"))
        got = images.decode_png(data)[..., 0]
    else:
        want = np.asarray(back)
        got = images.decode_image(data)
    np.testing.assert_array_equal(got.reshape(want.shape), want)


def test_image_modes_and_file_helpers(tmp_path):
    gray = _img((6, 8), np.uint8)
    path = str(tmp_path / "g.png")
    images.write_image(path, gray)
    np.testing.assert_array_equal(images.read_image(path), gray)
    rgba = images.read_image(path, "RGBA")
    assert rgba.shape == (6, 8, 4) and (rgba[..., 3] == 255).all()
    np.testing.assert_array_equal(rgba[..., 1], gray)
    assert images.read_image(path, "RGB").shape == (6, 8, 3)
    with pytest.raises(ValueError):
        images.decode_png(b"not a png")
    with pytest.raises(ValueError):
        images.encode_png(np.zeros((4, 4), np.float32))


# ---------------------------------------------------------------------------
# Main path without msgpack or Pillow
# ---------------------------------------------------------------------------

def test_snapshot_and_frame_without_msgpack_or_pil(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "msgpack", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    from nerf_glasses_tpu.io import snapshot as snap_io
    from nerf_glasses_tpu.models.renderer import NerfMeshRenderer

    snap = snap_io.load_snapshot(TRAINED)
    assert snap.params_blob.size > 0
    out = tmp_path / "copy.msgpack"
    snap_io.save_snapshot(str(out), snap.config, snap.params_blob,
                          snap.density_grid, snap.dataset, snap.aabb,
                          snap.render_aabb, snap.render_aabb_to_local)
    again = snap_io.load_snapshot(str(out))
    np.testing.assert_array_equal(again.params_blob, snap.params_blob)

    r = NerfMeshRenderer(32, 24)
    r.load_nerf(TRAINED)
    r.frame()
    frame = tmp_path / "frame.png"
    r.save_frame(str(frame))
    img = images.read_image(str(frame))
    assert img.shape == (24, 32, 3) and img.dtype == np.uint8

    jpg = tmp_path / "x.jpg"
    jpg.write_bytes(b"\xff\xd8\xff\xe0 not really a jpeg")
    with pytest.raises(ImportError, match="JPG"):
        images.read_image(str(jpg))
