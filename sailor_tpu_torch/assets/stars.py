"""Star catalogues (counterpart of sailor_tpu/assets/stars.py; SkyNode's
Yale Bright Star Catalogue reader and Morgan-Keenan -> temperature -> RGB
mapping, Runtime/FrameGraph/SkyNode.h:20-44).

``load(path)`` parses the BSC5 binary format; ``procedural(n)`` makes a
plausible star field with the same output: unit directions (S, 3) and
linear RGB intensities (S, 3), float32 numpy arrays. Host numpy only.
"""

from __future__ import annotations

import struct

import numpy as np

# Morgan-Keenan spectral class -> effective temperature (K)
MK_TEMPERATURE = {
    "O": 30000.0, "B": 20000.0, "A": 8750.0, "F": 6750.0,
    "G": 5600.0, "K": 4450.0, "M": 3050.0,
}


def blackbody_rgb(temp_k: np.ndarray) -> np.ndarray:
    """Approximate blackbody chromaticity -> linear RGB (Tanner Helland fit,
    vectorized). Input Kelvin, output [0,1]^3."""
    t = np.clip(np.asarray(temp_k, np.float64), 1000.0, 40000.0) / 100.0
    r = np.where(t <= 66, 255.0, 329.698727446 * np.maximum(t - 60, 1e-6) ** -0.1332047592)
    g = np.where(
        t <= 66,
        99.4708025861 * np.log(np.maximum(t, 1e-6)) - 161.1195681661,
        288.1221695283 * np.maximum(t - 60, 1e-6) ** -0.0755148492,
    )
    b = np.where(
        t >= 66,
        255.0,
        np.where(t <= 19, 0.0, 138.5177312231 * np.log(np.maximum(t - 10, 1e-6)) - 305.0447927307),
    )
    rgb = np.stack([r, g, b], -1) / 255.0
    srgb = np.clip(rgb, 0.0, 1.0)
    return (srgb**2.2).astype(np.float32)  # to linear


def _radec_to_dir(ra: np.ndarray, dec: np.ndarray) -> np.ndarray:
    """Equatorial coords (radians) -> engine direction (y up)."""
    cd = np.cos(dec)
    return np.stack([cd * np.cos(ra), np.sin(dec), cd * np.sin(ra)], -1).astype(
        np.float32
    )


def load(path: str, max_stars: int = 4096):
    """Parse a BSC5 binary catalog: 28-byte header then 32-byte entries of
    (xno f32, sra0 f64, sdec0 f64, spectral 2 bytes, mag i16 (x100),
    xrpm f32, xdpm f32)."""
    with open(path, "rb") as f:
        data = f.read()
    star0, star1, starn, stnum, mprop, nmag, nbent = struct.unpack_from(
        "<7i", data, 0
    )
    n = abs(starn)
    dirs, cols, mags = [], [], []
    off = 28
    for _ in range(n):
        if off + nbent > len(data):
            break
        xno, sra0, sdec0 = struct.unpack_from("<f2d", data, off)
        spec = data[off + 20 : off + 22].decode("ascii", "replace")
        (mag,) = struct.unpack_from("<h", data, off + 22)
        off += nbent
        letter = spec.strip()[:1].upper()
        temp = MK_TEMPERATURE.get(letter, 5600.0)
        m = mag / 100.0
        # visual magnitude -> linear relative intensity
        intensity = 10.0 ** (-0.4 * m)
        dirs.append(_radec_to_dir(np.float32(sra0), np.float32(sdec0)))
        cols.append(blackbody_rgb(temp) * intensity)
        mags.append(m)
    dirs = np.asarray(dirs, np.float32)
    cols = np.asarray(cols, np.float32)
    mags = np.asarray(mags, np.float32)
    if len(dirs) > max_stars:  # keep the brightest
        keep = np.argsort(mags)[:max_stars]
        dirs, cols = dirs[keep], cols[keep]
    return dirs, cols


def procedural(n: int = 2048, seed: int = 0):
    """Fallback star field: isotropic directions, power-law brightness,
    spectral-class mix approximating the bright-star population."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    dirs = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    classes = rng.choice(
        list(MK_TEMPERATURE.values()),
        size=n,
        p=[0.01, 0.12, 0.20, 0.25, 0.22, 0.13, 0.07],
    )
    mag = rng.uniform(0.0, 6.5, n)  # visual magnitudes
    intensity = (10.0 ** (-0.4 * mag))[:, None]
    cols = blackbody_rgb(classes) * intensity
    return dirs, cols.astype(np.float32)
