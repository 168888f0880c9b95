"""Write the port's HUD font atlas, sailor_tpu_torch/engine/font_atlas.npz.

The JAX package's overlay draws text with Pillow's
``ImageFont.load_default()``: with FreeType, Pillow 12 embeds Aileron
Regular at size 10 (by dot colon, Sora Sagano; released into the public
domain under CC0 1.0). The port has no Pillow, so it carries that font's
rendering: for each of the 95 printable ASCII characters its coverage mask
(Pillow's ``getmask2(ch, "L")``), the mask's offset from the pen and the
advance. Pillow's advances are whole pixels and no pair of these
characters is kerned, which the script checks, so a string is its glyphs
placed at the summed advances (engine/overlay.py composites them as
Pillow's ``font_render`` does).

Run on a machine with Pillow (and FreeType): ``python tests/torch_font_atlas.py``.
Not collected by pytest; tests/test_torch_overlay.py holds the atlas to
Pillow's rendering.
"""

import itertools
import os

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "sailor_tpu_torch", "engine", "font_atlas.npz")
CHARS = [chr(c) for c in range(32, 127)]


def build():
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.load_default()
    assert font.getname() == ("Aileron", "Regular") and font.size == 10, font.getname()
    masks, offsets, advances = [], [], []
    for ch in CHARS:
        m, off = font.getmask2(ch, "L")
        w, h = m.size
        masks.append(np.array(m, np.uint8).reshape(h, w))
        offsets.append(off)
        adv = font.getlength(ch)
        assert adv == int(adv), (ch, adv)
        advances.append(int(adv))
    for a, b in itertools.product(CHARS, CHARS):
        assert font.getlength(a + b) == advances[CHARS.index(a)] + advances[CHARS.index(b)], (a, b)
    draw = ImageDraw.Draw(Image.new("RGBA", (8, 8)))
    line_height = draw.textbbox((0, 0), "A", font=font)[3]
    sizes = np.asarray([m.shape for m in masks], np.int32)
    return {
        "codes": np.asarray([ord(c) for c in CHARS], np.int32),
        "sizes": sizes,
        "starts": np.concatenate([[0], np.cumsum(sizes.prod(1))]).astype(np.int32),
        "pixels": np.concatenate([m.reshape(-1) for m in masks]).astype(np.uint8),
        "offsets": np.asarray(offsets, np.int32),
        "advances": np.asarray(advances, np.int32),
        "line_height": np.int32(line_height),
    }


if __name__ == "__main__":
    np.savez_compressed(OUT, **build())
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
