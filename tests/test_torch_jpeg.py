"""The port's JPEG decoder (sailor_tpu_torch/utils/jpeg.py and the C++ of
csrc/image_decode.cpp) against ``imageio.v2.imread``, the reader the JAX
package's importers use (Pillow on libjpeg-turbo), on files Pillow
writes from seeded numpy data, on the files chip_smoke.py's own writer
(``jpeg_bytes``) gives the card's content phases, and on the codings
Pillow cannot write, from tests/torch_image_files.py:

- every file equal to imageio bit for bit, in dtype and shape: baseline
  4:4:4, 4:2:2 and 4:2:0, greyscale, progressive (colour and grey, also
  with restarts), optimised Huffman tables, restart intervals by blocks
  and by rows, qualities 10-100, sizes 1x1, 7x13, 37x53 and 24x2100, an
  Adobe RGB file (transform 0) and an EXIF orientation (neither applies
  it);
- arithmetic-coded files (SOF9 and SOF10: 4:2:0, 4:2:2, 4:4:4, grey,
  restart intervals, DAC conditioning, libjpeg's progression), CMYK and
  YCCK files, DNL segments before a scan and before EOI, lossless files
  (SOF3: grey and RGB, predictors 1-7, point transforms, restarts, one
  scan a component, RGB and unknown ids, an Adobe RGB marker, CMYK,
  subsampled components) and progressive files cut after each scan
  (libjpeg-turbo's block smoothing), through both paths and
  ``textures.imread``; the test-side writers are held to imageio too;
- the C++ entropy decoders, smoothing and pixel pass equal to the plain
  Python and numpy version on the small files;
- ``textures.imread``/``decode_bytes``/``load``/the registry, glTFs with
  JPEG images (one of every coding) against the reference's
  ``load_texture_images``, and the editor's JPEG preview
  (tests/test_torch_editor.py);
- the cases imageio refuses too raise errors that name them: hierarchical
  and arithmetic-coded lossless frames, 12-bit samples, 2-component
  frames, fractional sampling, lossless YCbCr, a lossless restart
  interval of part of a row, a frame of height 0 (DNL), and OpenEXR,
  which imageio cannot read without an optional plugin;
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


def _with_sof(data, marker=None, precision=None, sof=0xC0):
    out = bytearray(data)
    i = out.find(bytes([0xFF, sof]))
    if marker is not None:
        out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


@pytest.mark.parametrize("marker,name", [
    (0xC5, "SOF5"), (0xC6, "SOF6"), (0xC7, "SOF7"), (0xCB, "SOF11"), (0xCD, "SOF13")])
def test_refused_frames_name_their_sof(marker, name):
    """Hierarchical frames and arithmetic-coded lossless ones raise naming
    the SOF; imageio's libjpeg-turbo refuses each too. The SOF11 header is
    put over a lossless scan, whose scan header libjpeg accepts."""
    src = files.lossless_jpeg([_image(19, 23, grey=True)], 1) if marker == 0xCB else \
        CASES["baseline_420"]()
    data = _with_sof(src, marker, sof=0xC3 if marker == 0xCB else 0xC0)
    with pytest.raises(NotImplementedError, match=name):
        jpeg.decode_jpeg(data)
    with pytest.raises(Exception):
        imageio.imread(data)


@pytest.mark.parametrize("marker", [0xC9, 0xCA, 0xC3], ids=["SOF9", "SOF10", "SOF3"])
def test_sof_header_over_huffman_scans(marker):
    """A baseline file whose SOF says arithmetic-coded (SOF9): imageio
    decodes the Huffman bytes as arithmetic-coded ones into noise, and so
    does the port, bit for bit. Said progressive (SOF10) or lossless
    (SOF3), its scan header is invalid: both refuse it."""
    data = _with_sof(CASES["baseline_420"](), marker)
    if marker == 0xC9:
        want = imageio.imread(data)
        _equal(jpeg.decode_jpeg(data), want)
        _equal(jpeg.decode_jpeg(data, plain=True), want)
        return
    with pytest.raises(Exception):
        imageio.imread(data)
    for plain in (False, True):
        with pytest.raises(ValueError, match="^JPEG: invalid"):
            jpeg.decode_jpeg(data, plain=plain)


@pytest.mark.parametrize("kind", ["baseline", "lossless"])
def test_refused_12_bit(kind):
    src = files.lossless_jpeg([_image(19, 23, grey=True)], 1) if kind == "lossless" else \
        CASES["baseline_420"]()
    data = _with_sof(src, precision=12, sof=0xC3 if kind == "lossless" else 0xC0)
    with pytest.raises(NotImplementedError, match="12-bit"):
        jpeg.decode_jpeg(data)
    with pytest.raises(Exception):
        imageio.imread(data)


def _two_components():
    """A 4:4:4 file rewritten to a frame and scan of its first two
    components."""
    data = _pillow(_image(12, 20), subsampling=0)
    j = data.find(b"\xff\xc0")
    n = int.from_bytes(data[j + 2:j + 4], "big")
    sof = bytearray(data[j + 4:j + 2 + n])
    sof[5] = 2
    sof = bytes(sof[:12])
    k = data.find(b"\xff\xda")
    m = int.from_bytes(data[k + 2:k + 4], "big")
    sos = data[k + 4:k + 2 + m]
    sos = bytes([2]) + sos[1:5] + sos[7:]
    return (data[:j] + b"\xff\xc0" + (len(sof) + 2).to_bytes(2, "big") + sof + data[j + 2 + n:k]
            + b"\xff\xda" + (len(sos) + 2).to_bytes(2, "big") + sos + data[k + 2 + m:])


def _fractional():
    """Luma sampled 2x1 and Cb 3x1: 3 / 2 is not an integral ratio."""
    out = bytearray(_pillow(_image(12, 20), subsampling=0))
    j = out.find(b"\xff\xc0")
    out[j + 11], out[j + 14] = 0x21, 0x31
    return bytes(out)


@pytest.mark.parametrize("case,match", [("two_components", "2-component"),
                                        ("fractional", "fractional JPEG sampling")])
def test_refused_frames_that_imageio_refuses(case, match):
    """A 2-component frame (Pillow: "cannot handle 2-layer images") and
    fractional sampling factors (libjpeg-turbo's jdsample.c) raise in
    imageio; the port refuses them naming the case."""
    data = {"two_components": _two_components, "fractional": _fractional}[case]()
    with pytest.raises(Exception):
        imageio.imread(data)
    with pytest.raises(NotImplementedError, match=match):
        jpeg.decode_jpeg(data)


def test_dnl_height_zero_is_refused_as_imageio_refuses_it():
    """A frame of height 0 would take its height from a DNL segment, which
    libjpeg does not support ("Empty JPEG image (DNL not supported)")."""
    data = bytearray(CASES["baseline_420"]())
    j = data.find(b"\xff\xc0")
    data[j + 5:j + 7] = b"\0\0"
    i = data.find(b"\xff\xd9")
    data = bytes(data[:i]) + b"\xff\xdc\x00\x04\x00\x25" + bytes(data[i:])
    with pytest.raises(Exception):
        imageio.imread(data)
    for plain in (False, True):
        with pytest.raises(ValueError, match="DNL"):
            jpeg.decode_jpeg(data, plain=plain)


# ------------------------------------------------------------ codings Pillow cannot write

def transcode(data, **kw):
    """The quantised coefficients of a Huffman-coded file, arithmetic-coded
    (tests/torch_image_files.arith_jpeg): luma on conditioning tables 0,
    chroma on 1; ``kw`` as arith_jpeg takes it."""
    frame, _ = jpeg._read(data, plain=True)
    comps, quant = [], {}
    for i, c in enumerate(frame.comps):
        n = c.bw_alloc * c.bh_alloc
        comps.append({"id": c.cid, "h": c.h, "v": c.v, "tq": c.tq, "dc": min(i, 1),
                      "ac": min(i, 1), "coefs": frame.coefs[c.offset:c.offset + n].reshape(
                          c.bh_alloc, c.bw_alloc, 64)})
        quant[c.tq] = c.quant[jpeg.NATURAL_ORDER]
    return files.arith_jpeg(frame.width, frame.height, comps, quant, **kw)


def _cmyk(a, adobe=True, transform=None):
    buf = io.BytesIO()
    Image.fromarray(a).convert("CMYK").save(buf, format="JPEG", quality=90)
    data = buf.getvalue()
    i = data.find(b"\xff\xee")
    n = int.from_bytes(data[i + 2:i + 4], "big")
    if not adobe:
        return data[:i] + data[i + 2 + n:]
    if transform is not None:
        data = data[:i + 15] + bytes([transform]) + data[i + 16:]
    return data


def _with_dnl(where):
    data = CASES["baseline_420"]()
    i = data.find(b"\xff\xd9" if where == "eoi" else b"\xff\xda")
    return data[:i] + b"\xff\xdc\x00\x04\x00\x25" + data[i:]


def _lossless(pred, ncomp=3, **kw):
    a = _image(19, 23, grey=ncomp == 1, seed=pred)
    return files.lossless_jpeg([a] if ncomp == 1 else [a[..., i] for i in range(ncomp)], pred,
                               **kw)


def _lossless_subsampled(interleave=True, restart_rows=0):
    a = _image(19, 23, seed=8)
    return files.lossless_jpeg([a[..., 0], a[::2, ::2, 1], a[::2, ::2, 2]], 1,
                               sampling=[(2, 2), (1, 1), (1, 1)], interleave=interleave,
                               restart_rows=restart_rows)


PROGRESSION = files.simple_progression
ARITH = {  # name: (Huffman source, arith_jpeg arguments)
    "arith_420": (lambda: CASES["baseline_420"](), {}),
    "arith_444": (lambda: CASES["baseline_444"](), {}),
    "arith_422": (lambda: CASES["baseline_422"](), {}),
    "arith_grey": (lambda: CASES["grey"](), {}),
    "arith_restart": (lambda: CASES["baseline_420"](), {"restart": 3}),
    "arith_restart_grey": (lambda: CASES["grey"](), {"restart": 5}),
    "arith_dac": (lambda: CASES["baseline_420"](),
                  {"dac": [(0, 0, 0x52), (1, 0, 2), (0, 1, 0x10), (1, 1, 20)]}),
    "arith_dac_wide": (lambda: CASES["noise_q100"](), {"dac": [(0, 0, 0xF0), (1, 0, 63),
                                                               (0, 1, 0x11), (1, 1, 1)]}),
    "arith_progressive": (lambda: CASES["baseline_420"](), {"script": PROGRESSION(3)}),
    "arith_progressive_444": (lambda: CASES["baseline_444"](), {"script": PROGRESSION(3)}),
    "arith_progressive_grey": (lambda: CASES["grey"](), {"script": PROGRESSION(1)}),
    "arith_progressive_restart": (lambda: CASES["baseline_420"](),
                                  {"script": PROGRESSION(3), "restart": 2}),
    "arith_progressive_dac": (lambda: CASES["noise_q100"](),
                              {"script": PROGRESSION(3), "dac": [(0, 0, 0x31), (1, 1, 9)]}),
}
CODINGS = {
    **{k: (lambda src=src, kw=kw: transcode(src(), **kw)) for k, (src, kw) in ARITH.items()},
    "cmyk": lambda: _cmyk(_image(12, 20)),
    "cmyk_no_adobe": lambda: _cmyk(_image(12, 20), adobe=False),
    "cmyk_420": lambda: _cmyk(_image(33, 41)),
    "ycck": lambda: _cmyk(_image(12, 20), transform=2),
    "ycck_transform_1": lambda: _cmyk(_image(12, 20), transform=1),
    "dnl_before_sos": lambda: _with_dnl("sos"),
    "dnl_before_eoi": lambda: _with_dnl("eoi"),
    **{f"lossless_grey_p{p}": (lambda p=p: _lossless(p, 1)) for p in range(1, 8)},
    **{f"lossless_rgb_p{p}": (lambda p=p: _lossless(p)) for p in range(1, 8)},
    "lossless_al": lambda: _lossless(4, al=3),
    "lossless_grey_al": lambda: _lossless(7, 1, al=1),
    "lossless_restart": lambda: _lossless(5, restart_rows=3),
    "lossless_restart_al": lambda: _lossless(6, al=2, restart_rows=1),
    "lossless_one_scan_each": lambda: _lossless(3, interleave=False, restart_rows=2),
    "lossless_rgb_ids": lambda: _lossless(2, ids=[82, 71, 66]),
    "lossless_unknown_ids": lambda: _lossless(2, ids=[4, 5, 6]),
    "lossless_adobe_rgb": lambda: _lossless(1, adobe=0),
    "lossless_cmyk": lambda: files.lossless_jpeg(
        [_image(19, 23, seed=4)[..., i % 3] for i in range(4)], 4),
    "lossless_subsampled": lambda: _lossless_subsampled(),
    "lossless_subsampled_one_scan_each": lambda: _lossless_subsampled(False, restart_rows=1),
}


@pytest.mark.parametrize("name", list(CODINGS))
def test_jpeg_codings_match_imageio(name, tmp_path):
    """Arithmetic-coded (SOF9, SOF10), CMYK and YCCK, DNL and lossless
    (SOF3) files: the C++ decode, the plain one and ``textures.imread``
    each equal imageio bit for bit."""
    data = CODINGS[name]()
    want = imageio.imread(data)
    _equal(jpeg.decode_jpeg(data), want)
    _equal(jpeg.decode_jpeg(data, plain=True), want)
    path = tmp_path / "t.jpg"
    path.write_bytes(data)
    _equal(textures.imread(str(path)), want)


@pytest.mark.parametrize("name", list(ARITH))
def test_arith_writer_matches_its_huffman_source_in_imageio(name):
    """The test-side arithmetic coder is checked by imageio: the transcoded
    file decodes there to the same array as its Huffman source."""
    src, kw = ARITH[name]
    data = src()
    _equal(imageio.imread(transcode(data, **kw)), imageio.imread(data))


@pytest.mark.parametrize("name", [k for k in CODINGS if k.startswith("lossless")
                                  and "subsampled" not in k and "cmyk" not in k])
def test_lossless_writer_matches_its_samples_in_imageio(name):
    """The test-side lossless writer is checked by imageio: each file
    decodes there to its samples with the point transform's low bits
    cleared."""
    got = imageio.imread(CODINGS[name]())
    grey = "grey" in name
    seed = {"lossless_al": 4, "lossless_grey_al": 7, "lossless_restart": 5,
            "lossless_restart_al": 6, "lossless_one_scan_each": 3}.get(name)
    if seed is None:
        seed = int(name[-1]) if name[-2] == "p" else {"lossless_rgb_ids": 2,
                                                      "lossless_unknown_ids": 2,
                                                      "lossless_adobe_rgb": 1}[name]
    al = {"lossless_al": 3, "lossless_grey_al": 1, "lossless_restart_al": 2}.get(name, 0)
    _equal(got, (_image(19, 23, grey=grey, seed=seed) >> al) << al)


def _cuts(data):
    """``data`` cut after each of its scans but the last, each with an EOI."""
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    return [data[:i] + b"\xff\xd9" for i in sos[1:]]


PROGRESSIVE_CUTS = {  # name: (file, scans); the 40 x 70 file has an odd luma block row
    "colour": (lambda: CASES["progressive"](), 10),
    "colour_40x70": (lambda: _pillow(_image(40, 70), progressive=True), 10),
    "colour_444": (lambda: CASES["progressive_444"](), 10),
    "grey": (lambda: CASES["progressive_grey"](), 6),
    "arith_colour": (lambda: transcode(CASES["baseline_420"](), script=PROGRESSION(3)), 10),
}


@pytest.mark.parametrize("name,scans", [(k, n) for k, (_, total) in PROGRESSIVE_CUTS.items()
                                        for n in range(1, total)],
                         ids=[f"{k}-{n}" for k, (_, total) in PROGRESSIVE_CUTS.items()
                              for n in range(1, total)])
def test_progressive_cut_short_matches_imageio(name, scans):
    """A progressive file cut after each of its scans: libjpeg-turbo
    smooths the blocks whose first coefficients are incomplete (and, after
    the DC scans alone, their DC too); both paths equal imageio."""
    data = _cuts(PROGRESSIVE_CUTS[name][0]())[scans - 1]
    want = imageio.imread(data)
    _equal(jpeg.decode_jpeg(data), want)
    _equal(jpeg.decode_jpeg(data, plain=True), want)


@pytest.mark.parametrize("case", ["ycbcr", "adobe_ycc", "restart"])
def test_lossless_refusals_match_imageio(case):
    """libjpeg-turbo refuses a lossless file whose colour needs the lossy
    YCbCr conversion (a JFIF marker, or Adobe transform 1) and a restart
    interval that is not a whole number of MCU rows; so does the port."""
    if case == "restart":
        data = _lossless(1, restart_rows=2)
        k = data.find(b"\xff\xdd")
        data = data[:k + 4] + (23 * 2 - 1).to_bytes(2, "big") + data[k + 6:]
        err, match = ValueError, "restart interval"
    else:
        data = _lossless(1, jfif=True) if case == "ycbcr" else _lossless(1, adobe=1)
        err, match = NotImplementedError, "lossless JPEG files in YCbCr"
    with pytest.raises(Exception):
        imageio.imread(data)
    for plain in (False, True):
        with pytest.raises(err, match=match):
            jpeg.decode_jpeg(data, plain=plain)


def test_cmyk_texture_load_and_gltf_images_match_reference(tmp_path):
    """A CMYK JPEG through ``textures.load`` and a GLB of every new coding
    through ``load_texture_images``: the 4-channel array reaches the
    texture as the reference leaves it (K in alpha)."""
    from sailor_tpu.assets import gltf as j_gltf
    from sailor_tpu.assets import textures as j_textures
    from sailor_tpu_torch.assets import primitives

    path = tmp_path / "c.jpg"
    path.write_bytes(CODINGS["cmyk"]())
    got, want = textures.load(str(path)), np.asarray(j_textures.load(str(path)))
    assert got.shape == want.shape == (12, 20, 4)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    w = chip_smoke.GltfWriter()
    names = list(CODINGS)
    tex = [w.image_texture(CODINGS[k](), "image/jpeg") for k in names]
    w.material((1, 1, 1), 0.0, 0.5, albedo_texture=tex[0], normal_texture=tex[1])
    w.node(mesh=w.mesh(primitives.plane(1.0), 0))
    glb = tmp_path / "m.glb"
    glb.write_bytes(w.glb())
    got = gltf.GLTF.load(str(glb)).load_texture_images()
    want = j_gltf.GLTF.load(str(glb)).load_texture_images()
    assert len(got) == len(want) == len(names)
    for name, g, r in zip(names, got, want):
        assert g.shape == np.asarray(r).shape, name
        np.testing.assert_allclose(g, np.asarray(r), rtol=1e-6, atol=1e-7, err_msg=name)


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
