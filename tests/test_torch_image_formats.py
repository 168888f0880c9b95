"""The port's BMP, TGA and Radiance HDR decoders (sailor_tpu_torch/utils/bmp.py,
tga.py, hdr.py) against the readers the JAX package uses, on files the
tests write (with Pillow, and by hand with tests/torch_image_files.py):

- every BMP and TGA equal to ``imageio.v2.imread`` (dtype, shape, values):
  Pillow's BMP modes 1, L, P, RGB, RGBA and TGA modes 1, L, LA, P, RGB,
  RGBA (plain and RLE), and hand-built BMP 4-bit, 16-bit 5-5-5 and 5-6-5
  bit fields, 24-bit bit fields, 32-bit bit fields with alpha, a 52-byte
  header, the 12-byte core header, top-down rows, RLE8 and RLE4, and TGA
  16-bit, 32-bit top-left and right-to-left origins, colour maps of 16
  and 24 bits with a first-entry offset, an image ID, raw packets across
  rows (Pillow reads neither 32-bit colour maps nor run packets across
  rows; ``test_tga_cmap32`` holds the former to its map by hand);
- a BMP RLE delta moves by its two bytes (Pillow reads four there);
- Radiance HDR, flat and RLE, ``#?RADIANCE`` and ``#?RGBE``: equal to
  OpenCV's float read (``cv2.IMREAD_UNCHANGED``, BGR reversed) bit for bit;
  what imageio returns for the same file here (uint8, through its OpenCV
  plugin) is recorded as a fault of the reference's reader (ROADMAP C 5);
- ``textures.load`` (HDR stays linear float32), the registry, glTF images
  embedded as BMP, TGA and HDR by ``mimeType``, and ``decode_bytes``
  sniffing ``BM`` and ``#?``.
"""

import io
import json
import struct
import warnings

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

import torch_image_files as files
from sailor_tpu_torch.assets import gltf, textures
from sailor_tpu_torch.assets.registry import AssetRegistry
from sailor_tpu_torch.utils.bmp import decode_bmp
from sailor_tpu_torch.utils.hdr import decode_hdr
from sailor_tpu_torch.utils.tga import decode_tga

RNG = np.random.default_rng(0)
W, H = 13, 7
RGBA = RNG.integers(0, 256, (H, W, 4), dtype=np.uint8)
RGBA[2, 3:9] = RGBA[2, 3]  # runs for the RLE encoders
RGBA[5] = RGBA[5, 0]


def _pillow(mode, fmt, **kw):
    im = Image.fromarray(RGBA)
    im = im.quantize(16) if mode == "P" else im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, format=fmt, **kw)
    return buf.getvalue()


def _palette(n):
    return RNG.integers(0, 256, (n, 3), dtype=np.uint8)


def _bmp_cases():
    idx4 = RNG.integers(0, 16, (H, W)).astype(np.uint8)
    idx4[3, 2:11] = 5
    idx8 = RNG.integers(0, 200, (H, W)).astype(np.uint8)
    idx8[4, 1:12] = 77
    px16 = RNG.integers(0, 1 << 16, (H, W), dtype=np.uint16)
    le16 = np.stack([px16 & 255, px16 >> 8], -1).astype(np.uint8)
    bgra = RGBA[..., [2, 1, 0, 3]]
    cases = {f"pillow_{m}": _pillow(m, "BMP") for m in ("1", "L", "P", "RGB", "RGBA")}
    cases.update({
        "pal4": files.bmp(files.bmp_rows(idx4, 4), W, H, 4, palette=_palette(16)),
        "pal1_colour": files.bmp(files.bmp_rows(idx4 & 1, 1), W, H, 1, palette=_palette(2)),
        "rgb555": files.bmp(files.bmp_rows(le16, 16), W, H, 16),
        "bitfields565": files.bmp(files.bmp_rows(le16, 16), W, H, 16, compression=3,
                                  masks=(0xF800, 0x7E0, 0x1F)),
        "bitfields555": files.bmp(files.bmp_rows(le16, 16), W, H, 16, compression=3,
                                  masks=(0x7C00, 0x3E0, 0x1F)),
        "bitfields24": files.bmp(files.bmp_rows(RGBA[..., 2::-1], 24), W, H, 24,
                                 compression=3, masks=(0xFF0000, 0xFF00, 0xFF)),
        "bitfields32_bgra": files.bmp(files.bmp_rows(bgra, 32), W, H, 32, compression=3,
                                      masks=(0xFF0000, 0xFF00, 0xFF, 0xFF000000), header=56),
        "bitfields32_rgba_v5": files.bmp(files.bmp_rows(RGBA, 32), W, H, 32, compression=3,
                                         masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000),
                                         header=124),
        "bitfields32_bgrx_52": files.bmp(files.bmp_rows(bgra, 32), W, H, 32, compression=3,
                                         masks=(0xFF0000, 0xFF00, 0xFF), header=52),
        "raw32": files.bmp(files.bmp_rows(bgra, 32), W, H, 32),
        "top_down24": files.bmp(files.bmp_rows(RGBA[::-1, :, 2::-1], 24), W, H, 24,
                                top_down=True),
        "core12_pal8": files.bmp(files.bmp_rows(idx8, 8), W, H, 8, palette=_palette(256),
                                 header=12),
        "core12_rgb24": files.bmp(files.bmp_rows(RGBA[..., 2::-1], 24), W, H, 24, header=12),
        "rle8": files.bmp(files.rle8(idx8), W, H, 8, palette=_palette(200), compression=1),
        "rle4": files.bmp(files.rle4(idx4), W, H, 4, palette=_palette(16), compression=2),
        "grey8": files.bmp(files.bmp_rows(idx8, 8), W, H, 8,
                           palette=np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)),
    })
    return cases


def _tga_cases():
    idx = RNG.integers(3, 40, (H, W)).astype(np.uint8)
    px16 = RNG.integers(0, 1 << 16, (H * W,), dtype=np.uint16)
    le16 = np.stack([px16 & 255, px16 >> 8], -1).astype(np.uint8)
    bgra = RGBA[..., [2, 1, 0, 3]].reshape(-1, 4)
    bottom_up = RGBA[::-1, :, [2, 1, 0, 3]].reshape(-1, 4)
    map32 = RNG.integers(0, 256, (40, 4), dtype=np.uint8).tobytes()
    map16 = RNG.integers(0, 1 << 16, (37,), dtype=np.uint16).astype("<u2").tobytes()
    cases = {f"pillow_{m}": _pillow(m, "TGA") for m in ("1", "L", "LA", "P", "RGB", "RGBA")}
    cases.update({f"pillow_{m}_rle": _pillow(m, "TGA", compression="tga_rle")
                  for m in ("L", "LA", "P", "RGB", "RGBA")})
    cases.update({
        "true16": files.tga(le16.tobytes(), W, H, 16, 2),
        "true16_rle": files.tga(files.tga_rle(le16), W, H, 16, 10),
        "true32_top_left": files.tga(bgra.tobytes(), W, H, 32, 2, descriptor=0x28),
        "true32_right_to_left": files.tga(bottom_up.tobytes(), W, H, 32, 2, descriptor=0x18),
        "true32_top_right_rle": files.tga(files.tga_rle(bgra), W, H, 32, 10, descriptor=0x38),
        "true24_id": files.tga(bottom_up[:, :3].tobytes(), W, H, 24, 2, image_id=b"sailor"),
        "cmap16_offset": files.tga((idx - 3).tobytes(), W, H, 8, 1, cmap=map16, cmap_depth=16,
                                   cmap_start=3),
        "cmap24_rle": files.tga(files.tga_rle(idx.reshape(-1, 1)), W, H, 8, 9,
                                cmap=map32[:120], cmap_depth=24),
        "grey_rle_rows": files.tga(files.tga_rle(np.full((W * H, 1), 9, np.uint8), W),
                                   W, H, 8, 11),
        "true16_rle_rows": files.tga(files.tga_rle(le16, W), W, H, 16, 10),
    })
    return cases


BMP = _bmp_cases()
TGA = _tga_cases()


def _imageio(data, ext, tmp_path):
    path = tmp_path / f"image{ext}"
    path.write_bytes(data)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return imageio.imread(str(path))


@pytest.mark.parametrize("name", sorted(BMP))
def test_bmp_matches_imageio(tmp_path, name):
    want = _imageio(BMP[name], ".bmp", tmp_path)
    got = decode_bmp(BMP[name])
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, got.shape,
                                                                want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(TGA))
def test_tga_matches_imageio(tmp_path, name):
    want = _imageio(TGA[name], ".tga", tmp_path)
    got = decode_tga(TGA[name])
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, got.shape,
                                                                want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)


def test_bmp_rle_delta_moves_two_bytes():
    """RLE8 over a 4x3 frame: 2 pixels, a delta of (1 right, 1 down), 1
    pixel, end of bitmap; the skipped pixels stay 0."""
    stream = bytes([2, 7, 0, 2, 1, 1, 1, 9, 0, 1])
    data = files.bmp(stream, 4, 3, 8, palette=np.stack([np.arange(16)] * 3, 1) * 16,
                     compression=1)
    got = decode_bmp(data)
    want = np.zeros((3, 4, 3), np.uint8)
    want[2, 0:2] = 7 * 16  # file rows are bottom-up
    want[1, 3] = 9 * 16
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bad", [b"BM" + bytes(64), b"BM", b"BMxx" + bytes(8)])
def test_bmp_malformed_raises(bad):
    with pytest.raises(ValueError, match="BMP"):
        decode_bmp(bad)


def test_tga_cmap32():
    """A 32-bit colour map (BGRA entries) gives RGBA through the map."""
    idx = RNG.integers(0, 40, (H, W)).astype(np.uint8)
    ent = RNG.integers(0, 256, (40, 4), dtype=np.uint8)
    got = decode_tga(files.tga(idx[::-1].tobytes(), W, H, 8, 1, cmap=ent.tobytes(),
                               cmap_depth=32))
    np.testing.assert_array_equal(got, ent[:, [2, 1, 0, 3]][idx])


def test_tga_malformed_raises():
    with pytest.raises(ValueError, match="TGA"):
        decode_tga(TGA["true16"][:40])
    with pytest.raises(ValueError, match="TGA"):
        decode_tga(bytes(18))


def _hdr_image(h=9, w=21):
    rgb = RNG.uniform(0, 1, (h, w, 3)) ** 3 * np.array([40.0, 3.0, 0.2])
    rgb[3, 2:17] = rgb[3, 2]  # runs
    rgb[h - 2] = 0.0
    return files.rgbe(rgb)


@pytest.mark.parametrize("rle", [False, True], ids=["flat", "rle"])
@pytest.mark.parametrize("magic", [b"#?RADIANCE", b"#?RGBE"])
def test_hdr_matches_opencv(tmp_path, rle, magic):
    path = tmp_path / "sky.hdr"
    path.write_bytes(files.hdr(_hdr_image(), rle=rle, magic=magic))
    want = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)[..., ::-1]
    got = decode_hdr(path.read_bytes())
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert got.max() > 1.0  # high dynamic range survives


def test_hdr_narrow_rows_are_flat(tmp_path):
    """Rows under 8 pixels are never run-length encoded."""
    path = tmp_path / "narrow.hdr"
    path.write_bytes(files.hdr(_hdr_image(5, 6), rle=False))
    np.testing.assert_array_equal(decode_hdr(path.read_bytes()),
                                  cv2.imread(str(path), cv2.IMREAD_UNCHANGED)[..., ::-1])


def test_hdr_refuses_other_orientations():
    data = files.hdr(_hdr_image(), rle=False).replace(b"-Y 9 +X 21", b"+Y 9 +X 21")
    with pytest.raises(ValueError, match="Radiance HDR.*-Y H \\+X W"):
        decode_hdr(data)
    with pytest.raises(ValueError, match="Radiance HDR"):
        decode_hdr(files.hdr(_hdr_image(), rle=True)[:120])


def test_imageio_reads_hdr_as_8_bit(tmp_path):
    """The reference reads textures through imageio, which here takes a
    Radiance file through its OpenCV plugin and returns uint8 (H, W, 3);
    the reference's ``textures.load`` then treats it as 8-bit sRGB
    (ROADMAP C 5). The port decodes to float32 and keeps it linear."""
    path = tmp_path / "sky.hdr"
    path.write_bytes(files.hdr(_hdr_image(), rle=True))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = imageio.imread(str(path))
    assert ref.dtype == np.uint8 and ref.shape == (9, 21, 3)
    got = textures.load(str(path))
    assert got.dtype == np.float32 and got.shape == (9, 21, 4)
    np.testing.assert_array_equal(got[..., :3], decode_hdr(path.read_bytes()))
    np.testing.assert_array_equal(got[..., 3], 1.0)


@pytest.mark.parametrize("ext,data", [(".bmp", BMP["pillow_RGB"]), (".tga", TGA["pillow_RGBA"]),
                                      (".BMP", BMP["rle8"]), (".tga", TGA["cmap16_offset"])],
                         ids=["bmp", "tga", "BMP_upper", "tga_cmap16"])
def test_textures_load_matches_reference(tmp_path, ext, data):
    from sailor_tpu.assets import textures as j_textures

    path = tmp_path / f"t{ext}"
    path.write_bytes(data)
    got = textures.load(str(path), generate_mips=True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_textures.load(str(path), generate_mips=True)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=1e-7)


def test_decode_bytes_sniffs_and_undecoded_shrinks():
    np.testing.assert_array_equal(textures.decode_bytes(BMP["pal4"]), decode_bmp(BMP["pal4"]))
    hdr = files.hdr(_hdr_image(), rle=True)
    np.testing.assert_array_equal(textures.decode_bytes(hdr), decode_hdr(hdr))
    assert textures.UNDECODED == {".exr": "OpenEXR"}
    with pytest.raises(NotImplementedError, match="no OpenEXR decoder"):
        textures.decode_bytes(b"\x76\x2f\x31\x01" + bytes(20))
    with pytest.raises(ValueError, match="^GIF: "):  # sniffed, then malformed
        textures.decode_bytes(b"GIF89a" + bytes(20))


def test_registry_and_gltf_load_new_formats(tmp_path):
    """The registry loads .bmp, .tga and .hdr; a glTF with images embedded
    as BMP, TGA and HDR decodes each (BMP and HDR sniffed, TGA by its
    mimeType). The reference's glTF loader reads embedded images through
    imageio, which finds no reader for TGA bytes (no signature): its BMP
    image is compared."""
    from sailor_tpu.assets import gltf as j_gltf

    (tmp_path / "a.bmp").write_bytes(BMP["pillow_P"])
    (tmp_path / "b.tga").write_bytes(TGA["pillow_RGB_rle"])
    (tmp_path / "c.hdr").write_bytes(files.hdr(_hdr_image(), rle=False))
    reg = AssetRegistry(str(tmp_path))
    assert reg.scan_content_folder() == 3
    for name in ("a.bmp", "b.tga", "c.hdr"):
        img = reg.load(str(tmp_path / name))
        assert img.dtype == np.float32 and img.shape[-1] == 4 and np.isfinite(img).all()

    blobs = [BMP["bitfields32_bgra"], TGA["true32_top_left"], files.hdr(_hdr_image(), rle=True)]
    mimes = ["image/bmp", "image/x-tga", "image/vnd.radiance"]
    buf, views = b"", []
    for b in blobs:
        views.append({"buffer": 0, "byteOffset": len(buf), "byteLength": len(b)})
        buf += b + bytes(-len(b) % 4)
    doc = {"asset": {"version": "2.0"}, "buffers": [{"byteLength": len(buf),
                                                      "uri": "data.bin"}],
           "bufferViews": views,
           "images": [{"bufferView": i, "mimeType": m} for i, m in enumerate(mimes)]}
    (tmp_path / "m.gltf").write_text(json.dumps(doc))
    (tmp_path / "data.bin").write_bytes(buf)
    got = gltf.GLTF.load(str(tmp_path / "m.gltf")).load_texture_images()
    assert [g.shape for g in got] == [(H, W, 4), (H, W, 4), (9, 21, 4)]
    doc["images"] = doc["images"][:1]
    (tmp_path / "m.gltf").write_text(json.dumps(doc))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = j_gltf.GLTF.load(str(tmp_path / "m.gltf")).load_texture_images()
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-6, atol=1e-7)
    tga = decode_tga(blobs[1])
    np.testing.assert_allclose(got[1], (tga / np.float32(255.0)) ** 2.2, rtol=1e-6)
    np.testing.assert_array_equal(got[2][..., :3], decode_hdr(blobs[2]))  # linear, not sRGB


def test_bmp_header_fields_survive_struct_roundtrip():
    """The writer's 40-byte header: offset and sizes where decode_bmp reads them."""
    data = BMP["pal4"]
    assert data[:2] == b"BM"
    offset, hsize = struct.unpack_from("<I", data, 10)[0], struct.unpack_from("<I", data, 14)[0]
    assert hsize == 40 and offset == 14 + 40 + 16 * 4
