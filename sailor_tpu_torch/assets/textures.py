"""Texture import (counterpart of sailor_tpu/assets/textures.py,
Runtime/AssetRegistry/Texture/TextureImporter.cpp): decode, sRGB to
linear, mip generation, sampler meta from the `.asset` sidecar.

The reference decodes every format through imageio; the port has its own
decoders, since the card's machine has no image library: PNG
(``utils.png``, Adam7 too), JPEG (``utils.jpeg``, every coding imageio
reads: Huffman or arithmetic, sequential, progressive or lossless, CMYK
too), GIF (``utils.gif``, the first image), BMP (``utils.bmp``)
and TGA (``utils.tga``), each returning imageio's arrays bit for bit, and
Radiance HDR (``utils.hdr``), decoded to float32 linear RGB as OpenCV
reads it. OpenEXR raises NotImplementedError; imageio reads it only
through an optional plugin (ROADMAP A 10).
"""

from __future__ import annotations

import os

import numpy as np

from sailor_tpu_torch.utils.bmp import decode_bmp
from sailor_tpu_torch.utils.gif import SIGNATURES as GIF_SIGNATURES
from sailor_tpu_torch.utils.gif import decode_gif
from sailor_tpu_torch.utils.hdr import SIGNATURES as HDR_SIGNATURES
from sailor_tpu_torch.utils.hdr import decode_hdr
from sailor_tpu_torch.utils.jpeg import SIGNATURE as JPEG_SIGNATURE
from sailor_tpu_torch.utils.jpeg import decode_jpeg
from sailor_tpu_torch.utils.png import SIGNATURE, decode_png
from sailor_tpu_torch.utils.tga import decode_tga

#: image extensions the registry knows that the port does not decode (the
#: reference's imageio reads them only through an optional plugin)
UNDECODED = {".exr": "OpenEXR"}
#: decoders by extension (TGA has no signature to sniff)
DECODERS = {".png": decode_png, ".jpg": decode_jpeg, ".jpeg": decode_jpeg, ".gif": decode_gif,
            ".bmp": decode_bmp, ".tga": decode_tga, ".hdr": decode_hdr}
#: glTF ``mimeType``s of TGA, the one format without a signature to sniff
TGA_MIME_TYPES = ("image/x-tga", "image/tga", "image/x-targa")


def format_error(fmt: str, name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{fmt} image {name}: the port decodes PNG, JPEG, GIF, BMP, TGA and Radiance HDR; "
        f"no {fmt} decoder is ported (ROADMAP A 10: OpenEXR stays refused)")


def decode_bytes(data: bytes, name: str = "image", mime: str | None = None) -> np.ndarray:
    """Encoded image bytes -> the array imageio would give (HDR: float32
    linear RGB). The format is sniffed (PNG, ``FF D8 FF``, ``GIF8``, ``BM``,
    ``#?``); TGA, which has no signature, is taken from ``mime`` (a glTF
    image's ``mimeType``)."""
    if data[:8] == SIGNATURE:
        return decode_png(data)
    if data[:3] == JPEG_SIGNATURE:
        return decode_jpeg(data)
    if data[:6] in GIF_SIGNATURES:
        return decode_gif(data)
    if data[:2] == b"BM":
        return decode_bmp(data)
    if data.startswith(HDR_SIGNATURES):
        return decode_hdr(data)
    if mime in TGA_MIME_TYPES:
        return decode_tga(data)
    fmt = "OpenEXR" if data[:4] == b"\x76\x2f\x31\x01" else "unknown-format"
    raise format_error(fmt, name)


def imread(path: str) -> np.ndarray:
    """A file as imageio.v2.imread reads it (HDR: as OpenCV's float read),
    dispatched by extension."""
    ext = os.path.splitext(path)[1].lower()
    if ext in UNDECODED:
        raise format_error(UNDECODED[ext], path)
    with open(path, "rb") as f:
        data = f.read()
    if ext in DECODERS:
        return DECODERS[ext](data)
    return decode_bytes(data, path)


def load(path: str, *, srgb: bool | None = None, flip_y: bool = False,
         generate_mips: bool = False, **_ignored):
    """Decode to float32 linear RGBA (H, W, 4). HDR formats stay linear."""
    arr = np.asarray(imread(path))
    is_hdr = arr.dtype in (np.float32, np.float64, np.float16)
    if srgb is None:
        srgb = not is_hdr
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    elif arr.dtype == np.uint16:
        arr = arr.astype(np.float32) / 65535.0
    else:
        arr = arr.astype(np.float32)
    if srgb:
        arr = arr**2.2
    if arr.ndim == 2:
        arr = arr[..., None].repeat(3, -1)
    if arr.shape[-1] == 3:
        arr = np.concatenate([arr, np.ones_like(arr[..., :1])], -1)
    if flip_y:
        arr = arr[::-1]
    if generate_mips:
        return mip_chain(arr)
    return arr


def mip_chain(img: np.ndarray) -> list[np.ndarray]:
    """Box-filtered mip pyramid down to 1x1."""
    mips = [img]
    cur = img
    while min(cur.shape[0], cur.shape[1]) > 1:
        h2, w2 = max(1, cur.shape[0] // 2), max(1, cur.shape[1] // 2)
        cur = cur[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2, -1).mean(axis=(1, 3))
        mips.append(cur.astype(np.float32))
    return mips
