"""The port's GIF decoder (sailor_tpu_torch/utils/gif.py and its LZW in
csrc/image_decode.cpp) against ``imageio.v2.imread`` (through Pillow), on
files Pillow writes from seeded numpy data and on files written by hand
(tests/torch_image_files.py: ``gif`` and its LZW encoder):

- the first image equal to imageio bit for bit, in dtype and shape:
  Pillow's P (also with a transparency index and interlaced), L, RGB and
  several-frame files and a 1x1 image; by hand a global and a local
  colour table, an image offset inside the screen and one that grows it,
  a transparency index filling the uncovered canvas, no colour table and
  the grey ramp Pillow drops (both (H, W)), indices past a short table,
  a minimum code size of 2 and 3, interlaced rows, a full table cleared,
  kept (the deferred clear) and cleared early, and a 1024 x 1024 image;
- the C++ LZW equal to the plain Python one on every file;
- ``textures.imread`` and the registry read ``.gif``; a malformed file
  raises ValueError("GIF: ...").
"""

import io

import imageio.v2 as imageio
import numpy as np
import pytest
from PIL import Image

import torch_image_files as files
from sailor_tpu_torch.assets import textures
from sailor_tpu_torch.assets.registry import AssetRegistry
from sailor_tpu_torch.utils import gif


def _pillow(img, **kw):
    buf = io.BytesIO()
    img.save(buf, format="GIF", **kw)
    return buf.getvalue()


def _cases():
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 16, (40, 50)).astype(np.uint8)
    p = Image.fromarray(idx, "P")
    p.putpalette(list(rng.integers(0, 256, 48)))
    frames = [Image.fromarray(rng.integers(0, 256, (24, 24, 3), dtype=np.uint8))
              for _ in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, format="GIF", save_all=True, append_images=frames[1:])
    pal = rng.integers(0, 256, (200, 3)).astype(np.uint8)
    big = rng.integers(0, 200, (300, 300)).astype(np.uint8)
    local = rng.integers(0, 256, (4, 3)).astype(np.uint8)
    small = rng.integers(0, 8, (20, 17)).astype(np.uint8)
    ramp = np.repeat(np.arange(8, dtype=np.uint8)[:, None], 3, 1)
    return {
        "pillow_P": _pillow(p),
        "pillow_transparency": _pillow(p, transparency=3),
        "pillow_interlaced": _pillow(p, interlace=True),
        "pillow_L": _pillow(Image.fromarray(rng.integers(0, 256, (30, 20), dtype=np.uint8), "L")),
        "pillow_RGB": _pillow(Image.fromarray(rng.integers(0, 256, (33, 21, 3),
                                                           dtype=np.uint8))),
        "pillow_frames": buf.getvalue(),
        "pillow_1x1": _pillow(Image.fromarray(np.array([[7]], np.uint8), "P")),
        "deferred_clear": files.gif([{"indices": big}], 300, 300, global_palette=pal,
                                    clear_when_full=False),
        "clear_when_full": files.gif([{"indices": big}], 300, 300, global_palette=pal),
        "clear_early": files.gif([{"indices": big[:50]}], 300, 50, global_palette=pal,
                                 clear_every=100),
        "local_offset": files.gif([{"indices": small, "x": 5, "y": 3, "palette": local,
                                    "min_code": 3}], 30, 30, global_palette=pal[:16]),
        "offset_transparency": files.gif([{"indices": small, "x": 5, "y": 3, "min_code": 3}],
                                         30, 30, global_palette=pal[:16], transparency=9),
        "grows_screen": files.gif([{"indices": small, "x": 20, "y": 25, "min_code": 3}], 30, 30,
                                  global_palette=pal[:8]),
        "no_table": files.gif([{"indices": small, "min_code": 3}], 17, 20),
        "grey_ramp": files.gif([{"indices": small, "min_code": 3}], 17, 20,
                               global_palette=ramp),
        "short_table": files.gif([{"indices": small, "min_code": 3}], 17, 20,
                                 global_palette=pal[:3]),
        "interlaced": files.gif([{"indices": big[:37, :41], "interlace": True}], 41, 37,
                                global_palette=pal),
        "two_images": files.gif([{"indices": small, "min_code": 3},
                                 {"indices": small[::-1], "min_code": 3, "palette": local}],
                                17, 20, global_palette=pal[:8]),
        "min_code_2": files.gif([{"indices": small % 4, "min_code": 2}], 17, 20,
                                global_palette=pal[:4]),
    }


CASES = _cases()


@pytest.mark.parametrize("name", list(CASES))
def test_gif_matches_imageio(name):
    data = CASES[name]
    want = imageio.imread(data)
    for got in (textures.decode_bytes(data), gif.decode_gif(data, plain=True)):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_large_gif_matches_imageio_and_plain():
    rng = np.random.default_rng(7)
    data = files.gif([{"indices": rng.integers(0, 256, (1024, 1024)).astype(np.uint8)}],
                     1024, 1024, global_palette=rng.integers(0, 256, (256, 3)).astype(np.uint8))
    got = gif.decode_gif(data)
    np.testing.assert_array_equal(got, imageio.imread(data))
    lzw_start = data.index(b",") + 10  # the image's LZW sub-blocks
    joined, _ = gif._sub_blocks(data, lzw_start + 1)
    np.testing.assert_array_equal(gif._lzw_native(joined, 8, 1024 * 1024)[:65536],
                                  gif.lzw_plain(joined, 8, 65536))


def test_imread_and_registry(tmp_path):
    from sailor_tpu.assets import textures as j_textures

    path = tmp_path / "t.gif"
    path.write_bytes(CASES["local_offset"])
    np.testing.assert_array_equal(textures.imread(str(path)), imageio.imread(str(path)))
    reg = AssetRegistry(str(tmp_path))
    assert reg.scan_content_folder() == 1
    np.testing.assert_allclose(reg.load(str(path)), np.asarray(j_textures.load(str(path))),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("data", [b"", b"GIF89a" + bytes(7), b"GIF89a" + bytes(7) + b"!"],
                         ids=["empty", "no_image", "truncated"])
def test_malformed_gif_raises_value_error(data):
    with pytest.raises(ValueError, match="^GIF: "):
        gif.decode_gif(data)
