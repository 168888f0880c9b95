"""The port's JPEG decoder (sailor_tpu_torch/utils/jpeg.py and the C++ of
csrc/image_decode.cpp) against ``imageio.v2.imread``, the reader the JAX
package's importers use (Pillow on libjpeg-turbo), on files Pillow
writes from seeded numpy data and on the baseline files chip_smoke.py's
own writer (``jpeg_bytes``) gives the card's content phases:

- every file equal to imageio bit for bit, in dtype and shape: baseline
  4:4:4, 4:2:2 and 4:2:0, greyscale, progressive (colour and grey, also
  with restarts), optimised Huffman tables, restart intervals by blocks
  and by rows, qualities 10-100, sizes 1x1, 7x13, 37x53 and 24x2100, an
  Adobe RGB file (transform 0) and an EXIF orientation (neither applies
  it);
- the C++ entropy decoder and pixel pass equal to the plain Python and
  numpy version on the small files;
- ``textures.imread``/``decode_bytes``/the registry, a glTF with a JPEG
  image against the reference's ``load_texture_images``, and the editor's
  JPEG preview (tests/test_torch_editor.py);
- the refused cases raise errors that name them, and what imageio does
  with each is recorded: arithmetic coding (SOF9: imageio decodes it),
  lossless and hierarchical frames, 12-bit samples and CMYK, and a
  progressive file cut short (imageio smooths its blocks); OpenEXR, which
  imageio cannot read without an optional plugin;
- malformed files that libjpeg refuses (Huffman tables that overfill the
  code space or hold a DC symbol above 15, a scan naming a component
  twice, an MCU of more than 10 blocks) raise ValueError on both paths,
  and the C++ scan refuses such tables and blocks itself.
"""

import io
import os
import sys

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

import torch_image_files as files
from sailor_tpu_torch.assets import gltf, textures
from sailor_tpu_torch.assets.registry import AssetRegistry
from sailor_tpu_torch.utils import jpeg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def _image(h, w, grey=False, seed=0):
    """A smooth field with noise: content that exercises every coefficient."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    base = (np.sin(xx / 7.0) + np.cos(yy / 5.0)) * 60 + 128
    if grey:
        return np.clip(base + rng.normal(0, 25, (h, w)), 0, 255).astype(np.uint8)
    tint = np.array([1.0, 0.7, 0.4])
    return np.clip(base[..., None] * tint + rng.normal(0, 25, (h, w, 3)), 0,
                   255).astype(np.uint8)


def _pillow(a, **kw):
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, format="JPEG", **kw)
    return buf.getvalue()


CASES = {
    "baseline_444": lambda: _pillow(_image(37, 53), subsampling=0, quality=85),
    "baseline_422": lambda: _pillow(_image(37, 53), subsampling=1, quality=85),
    "baseline_420": lambda: _pillow(_image(37, 53), subsampling=2, quality=85),
    "grey": lambda: _pillow(_image(37, 53, grey=True)),
    "progressive": lambda: _pillow(_image(61, 47), progressive=True),
    "progressive_444": lambda: _pillow(_image(40, 33), progressive=True, subsampling=0),
    "progressive_grey": lambda: _pillow(_image(33, 29, grey=True), progressive=True),
    "progressive_restart": lambda: _pillow(_image(40, 70), progressive=True,
                                           restart_marker_rows=1),
    "optimized": lambda: _pillow(_image(37, 53), optimize=True),
    "restart_blocks": lambda: _pillow(_image(37, 53), restart_marker_blocks=2),
    "restart_rows": lambda: _pillow(_image(48, 40), restart_marker_rows=1, subsampling=1),
    "1x1": lambda: _pillow(_image(1, 1)),
    "7x13": lambda: _pillow(_image(7, 13)),
    "3x2": lambda: _pillow(_image(3, 2)),
    "9x5_422": lambda: _pillow(_image(9, 5), subsampling=1),
    "wide_2100": lambda: _pillow(_image(24, 2100), quality=75),
    "noise_q100": lambda: _pillow(np.random.default_rng(3).integers(0, 256, (16, 24, 3),
                                                                    dtype=np.uint8), quality=100),
    "adobe_rgb": lambda: _pillow(_image(21, 34), keep_rgb=True),
}


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, got.shape,
                                                                 want.dtype, want.shape)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", list(CASES))
def test_jpeg_matches_imageio(name):
    data = CASES[name]()
    want = imageio.imread(data)
    _equal(textures.decode_bytes(data), want)
    if name != "wide_2100":
        _equal(jpeg.decode_jpeg(data, plain=True), want)


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_jpeg_qualities_match_imageio(subsampling):
    rng = np.random.default_rng(subsampling)
    for q in range(10, 101, 10):
        a = rng.integers(0, 256, (19, 27, 3), dtype=np.uint8)
        data = _pillow(a, quality=q, subsampling=subsampling, progressive=bool(q % 20))
        _equal(jpeg.decode_jpeg(data), imageio.imread(data))


def test_jpeg_exif_orientation_is_not_applied():
    a = _image(20, 30)
    exif = Image.Exif()
    exif[0x0112] = 6  # rotate 90 degrees on display
    data = _pillow(a, exif=exif.tobytes())
    want = imageio.imread(data)
    assert want.shape == (20, 30, 3)
    _equal(jpeg.decode_jpeg(data), want)


@pytest.mark.parametrize("size", [(1, 1), (7, 13), (37, 53), (33, 70)], ids=str)
@pytest.mark.parametrize("restart_rows", [0, 1, 2])
def test_chip_smoke_writer_decodes_as_imageio(size, restart_rows):
    """The baseline 4:2:0 files the card's content phases embed: the port
    and imageio agree, and a smooth image comes back close to its source."""
    h, w = size
    a = _image(h, w, seed=h + w)
    data = chip_smoke.jpeg_bytes(a, restart_rows=restart_rows)
    want = imageio.imread(data)
    _equal(jpeg.decode_jpeg(data), want)
    _equal(jpeg.decode_jpeg(data, plain=True), want)
    smooth = np.clip(np.mgrid[:h, :w][1][..., None] * np.array([2, 1, 3]) % 256, 0,
                     255).astype(np.uint8)
    back = jpeg.decode_jpeg(chip_smoke.jpeg_bytes(smooth, restart_rows=restart_rows))
    assert np.abs(back.astype(int) - smooth).mean() < 6


def test_chip_smoke_writer_map_decodes_as_imageio():
    """``map_jpeg`` on a procedural map (256 px here; the card's run takes
    2048), whose restart interval is one MCU row."""
    from sailor_tpu_torch.scenes import procedural_test_maps

    data = chip_smoke.map_jpeg(procedural_test_maps(0, 256)[1])
    assert b"\xff\xdd" in data and b"\xff\xd0" in data
    _equal(jpeg.decode_jpeg(data), imageio.imread(data))


def _with_sof(data, marker=None, precision=None):
    out = bytearray(data)
    i = out.find(b"\xff\xc0")
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


@pytest.mark.parametrize("marker,name,imageio_reads", [
    (0xC9, "SOF9", True), (0xCA, "SOF10", False), (0xC3, "SOF3", False), (0xC5, "SOF5", False),
    (0xCD, "SOF13", False)])
def test_refused_frames_name_their_sof(marker, name, imageio_reads):
    """Arithmetic-coded, lossless and hierarchical frames raise naming the
    SOF. imageio's libjpeg-turbo has an arithmetic decoder: it reads a
    SOF9 header (here over Huffman data, so the pixels are noise); a SOF10
    header over these sequential scans, and the others, it refuses too."""
    data = _with_sof(CASES["baseline_420"](), marker)
    with pytest.raises(NotImplementedError, match=name):
        jpeg.decode_jpeg(data)
    if imageio_reads:
        assert imageio.imread(data).shape == (37, 53, 3)
    else:
        with pytest.raises(Exception):
            imageio.imread(data)


def test_refused_12_bit_and_cmyk():
    data = _with_sof(CASES["baseline_420"](), precision=12)
    with pytest.raises(NotImplementedError, match="12-bit"):
        jpeg.decode_jpeg(data)
    with pytest.raises(Exception):
        imageio.imread(data)
    buf = io.BytesIO()
    Image.fromarray(_image(12, 20)).convert("CMYK").save(buf, format="JPEG")
    assert imageio.imread(buf.getvalue()).shape == (12, 20, 4)
    with pytest.raises(NotImplementedError, match="CMYK"):
        jpeg.decode_jpeg(buf.getvalue())


def test_progressive_cut_short_is_refused():
    """A progressive file whose later scans are cut leaves AC coefficients
    incomplete: libjpeg smooths such blocks (imageio reads it), the port
    refuses and names the case."""
    data = CASES["progressive"]()
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    cut = data[:sos[2]] + b"\xff\xd9"  # the DC scans and one AC scan
    assert imageio.imread(cut).shape == (61, 47, 3)
    with pytest.raises(NotImplementedError, match="block smoothing"):
        jpeg.decode_jpeg(cut)


def test_malformed_jpeg_raises_value_error():
    with pytest.raises(ValueError, match="^JPEG: "):
        jpeg.decode_jpeg(b"")
    with pytest.raises(ValueError, match="^JPEG: "):
        jpeg.decode_jpeg(b"\xff\xd8\xff\xd9")
    data = CASES["baseline_420"]()
    with pytest.raises(ValueError, match="^JPEG: "):
        jpeg.decode_jpeg(data[:data.find(b"\xff\xc0") + 6])  # a cut frame header


def _bad_dc_table(data, how):
    """``data`` with its first Huffman table (DC 0, 12 symbols) made one
    that libjpeg refuses (jdhuff.c, JERR_BAD_HUFF_TABLE)."""
    out = bytearray(data)
    i = out.find(b"\xff\xc4") + 4  # the table's class and slot byte
    assert out[i] == 0x00 and sum(out[i + 1:i + 17]) == 12
    if how == "overfull":  # three codes of one bit
        out[i + 1:i + 17] = bytes([3, 9] + [0] * 14)
    elif how == "all_ones":  # a complete code whose last code is 11111111111
        out[i + 1:i + 17] = bytes([1] * 10 + [2] + [0] * 5)
    else:  # a DC symbol above 15
        out[i + 17 + 11] = 16
    return bytes(out)


@pytest.mark.parametrize("how", ["overfull", "all_ones", "dc_symbol"])
def test_malformed_huffman_table_raises_value_error(how):
    """A Huffman table libjpeg refuses raises ValueError on both paths
    before any decoding (imageio raises OSError); the C++ scan, given such
    a table directly, returns -1 without writing past its lookahead
    table."""
    import ctypes

    from sailor_tpu_torch.kernels import host_lib

    data = _bad_dc_table(CASES["baseline_420"](), how)
    for plain in (False, True):
        with pytest.raises(ValueError, match="^JPEG: malformed JPEG Huffman table"):
            jpeg.decode_jpeg(data, plain=plain)
    with pytest.raises(OSError):
        imageio.imread(data)

    i = data.find(b"\xff\xc4") + 5
    tab = np.zeros((2, 4, 272), np.int32)
    tab[0, 0, :16] = list(data[i:i + 16])
    tab[0, 0, 16:28] = list(data[i + 16:i + 28])
    tab[1, 0, :16] = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]  # Annex K's AC 0
    tab[1, 0, 16:16 + 162] = np.arange(162)
    params = np.array([0, 63, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0], np.int32)
    coefs = np.zeros((1, 64), np.int16)
    ip = ctypes.POINTER(ctypes.c_int32)
    scan = host_lib.load("image").sailor_torch_jpeg_scan
    stream = bytes(64) + b"\xff\xd9"
    assert scan(stream, len(stream), 0, params.ctypes.data_as(ip), tab.ctypes.data_as(ip),
                coefs.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))) == -1
    good = CASES["baseline_420"]()
    j = good.find(b"\xff\xc4") + 5
    tab[0, 0, :28] = list(good[j:j + 28])
    assert scan(stream, len(stream), 0, params.ctypes.data_as(ip), tab.ctypes.data_as(ip),
                coefs.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))) == 64


def _bad_scan(how):
    """A file whose scan libjpeg refuses: a grey frame sampled 2x2 whose
    scan names its one component twice (the interleaved MCU would address
    blocks the frame does not hold), or a 4:2:0 frame whose luma is
    sampled 4x4 (an MCU of 18 blocks; jdinput.c allows 10)."""
    if how == "twice":
        out = bytearray(_pillow(_image(16, 16, grey=True)))
        out[out.find(b"\xff\xc0") + 11] = 0x22
        j = out.find(b"\xff\xda")
        n = int.from_bytes(out[j + 2:j + 4], "big")
        seg = out[j + 4:j + 2 + n]
        seg = bytes([2, seg[1], seg[2], seg[1], seg[2]]) + seg[3:]
        return bytes(out[:j + 2]) + (len(seg) + 2).to_bytes(2, "big") + seg + bytes(out[j + 2 + n:])
    out = bytearray(_pillow(_image(16, 16), subsampling=2))
    out[out.find(b"\xff\xc0") + 11] = 0x44
    return bytes(out)


@pytest.mark.parametrize("how", ["twice", "mcu_18_blocks"])
def test_malformed_scan_raises_value_error(how):
    """Scans libjpeg refuses raise ValueError on both paths (imageio raises
    OSError); the C++ scan returns -1 for a block outside its coefficients
    rather than writing there."""
    import ctypes

    from sailor_tpu_torch.kernels import host_lib

    data = _bad_scan(how)
    for plain in (False, True):
        with pytest.raises(ValueError, match="^JPEG: JPEG (scan names|MCU of)"):
            jpeg.decode_jpeg(data, plain=plain)
    with pytest.raises(OSError):
        imageio.imread(data)
    good = CASES["baseline_420"]()
    i = good.find(b"\xff\xc4") + 5
    tab = np.zeros((2, 4, 272), np.int32)
    tab[0, 0, :28] = list(good[i:i + 28])
    tab[1, 0, :16] = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]  # Annex K's AC 0
    tab[1, 0, 16:16 + 162] = np.arange(162)
    coefs = np.zeros((2, 64), np.int16)
    ip = ctypes.POINTER(ctypes.c_int32)
    scan = host_lib.load("image").sailor_torch_jpeg_scan
    stream = bytes(64) + b"\xff\xd9"
    for blocks, want in ((1, -1), (2, 64)):  # one component of 2 x 1 blocks
        params = np.array([0, 63, 0, 0, 0, 0, 2, 1, 1, blocks, 1, 1, 2, 1, 2, 0, 0, 0],
                          np.int32)
        assert scan(stream, len(stream), 0, params.ctypes.data_as(ip), tab.ctypes.data_as(ip),
                    coefs.ctypes.data_as(ctypes.POINTER(ctypes.c_int16))) == want


def test_native_and_plain_agree_on_every_small_case():
    for name, make in CASES.items():
        if name == "wide_2100":
            continue
        data = make()
        _equal(jpeg.decode_jpeg(data), jpeg.decode_jpeg(data, plain=True))


def test_imread_registry_and_texture_load(tmp_path):
    from sailor_tpu.assets import textures as j_textures

    data = CASES["baseline_420"]()
    for ext in (".jpg", ".jpeg"):
        path = tmp_path / f"t{ext}"
        path.write_bytes(data)
        _equal(textures.imread(str(path)), imageio.imread(str(path)))
    reg = AssetRegistry(str(tmp_path))
    assert reg.scan_content_folder() == 2
    got = reg.load(str(tmp_path / "t.jpg"))
    want = np.asarray(j_textures.load(str(tmp_path / "t.jpg")))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_gltf_jpeg_images_match_reference(tmp_path):
    """A GLB whose two maps are JPEGs (the card's writer and Pillow's
    progressive file) loads through ``gltf.load_merged`` and its images
    equal the reference's ``load_texture_images``."""
    from sailor_tpu.assets import gltf as j_gltf
    from sailor_tpu_torch.scenes import procedural_test_maps

    w = chip_smoke.GltfWriter()
    maps = procedural_test_maps(0, 32)
    a = w.image_texture(chip_smoke.map_jpeg(maps[0]), "image/jpeg")
    b = w.image_texture(CASES["progressive"](), "image/jpeg")
    w.material((1, 1, 1), 0.0, 0.5, albedo_texture=a, normal_texture=b)
    from sailor_tpu_torch.assets import primitives

    w.node(mesh=w.mesh(primitives.plane(1.0), 0))
    path = tmp_path / "m.glb"
    path.write_bytes(w.glb())
    soup, mats = gltf.load_merged(str(path))
    assert len(soup["indices"]) == 2 and list(mats["albedo_texture"]) == [0]
    got = gltf.GLTF.load(str(path)).load_texture_images()
    want = j_gltf.GLTF.load(str(path)).load_texture_images()
    assert len(got) == len(want) == 2
    for g, r in zip(got, want):
        assert g.shape == np.asarray(r).shape
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-6, atol=1e-7)


def test_openexr_stays_refused_here_and_in_imageio(tmp_path):
    data = files.exr_minimal()
    path = tmp_path / "a.exr"
    path.write_bytes(data)
    with pytest.raises(Exception):
        imageio.imread(str(path))
    with pytest.raises(NotImplementedError, match="no OpenEXR decoder"):
        textures.imread(str(path))
    with pytest.raises(NotImplementedError, match="OpenEXR"):
        textures.decode_bytes(data)
    assert textures.UNDECODED == {".exr": "OpenEXR"}
