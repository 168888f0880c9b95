"""Procedural sky (counterpart of sailor_tpu/kernels/sky.py): Rayleigh/Mie
single scattering, a raymarched FBM cloud slab and the sun disc, as dense
functions of the view direction over any (..., 3) batch.

What the port has: ``SkyParams``, ``phase_rayleigh``, ``phase_hg``,
``_ray_sphere_exit``, ``atmosphere``, ``clouds``, ``sun_disc`` and
``stars`` and ``sky_radiance`` (with ``cloud_stride``, ``cloud_override``
and the star field of ``assets/stars.py``); the path tracer bakes its
environment map and the frame graph's Sky and Environment nodes render
with them.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from sailor_tpu_torch.core import math3d as m3
from sailor_tpu_torch.core.noise import fbm3
from sailor_tpu_torch.kernels import sampling

EARTH_R = 6371e3
ATMOSPHERE_H = 100e3
CLOUD_START = 1500.0
CLOUD_END = 4000.0
SUN_ANGULAR_R = 0.00952  # ~0.545 deg in radians

# Rayleigh/Mie coefficients at sea level (per meter)
BETA_R = (5.802e-6, 13.558e-6, 33.1e-6)
BETA_M = (3.996e-6, 3.996e-6, 3.996e-6)
H_R = 8500.0
H_M = 1200.0


@dataclasses.dataclass
class SkyParams:
    """The sky's parameters: numpy float32 scalars, and the (3,) sun
    direction from the sun toward the scene."""

    sun_direction: np.ndarray
    sun_intensity: np.float32
    clouds_coverage: np.float32
    clouds_density: np.float32
    clouds_attenuation1: np.float32
    clouds_attenuation2: np.float32
    phase_influence1: np.float32
    phase_influence2: np.float32
    eccentricity1: np.float32
    eccentricity2: np.float32
    fog: np.float32
    ambient: np.float32

    @classmethod
    def default(cls, sun_direction=(-0.3, -0.4, -0.5), sun_intensity=20.0,
                clouds_coverage=0.3, clouds_density=0.6):
        f = np.float32
        sd = np.asarray(sun_direction, np.float32)
        return cls(
            sun_direction=sd / np.linalg.norm(sd),
            sun_intensity=f(sun_intensity),
            clouds_coverage=f(clouds_coverage),
            clouds_density=f(clouds_density),
            clouds_attenuation1=f(0.3),
            clouds_attenuation2=f(0.2),
            phase_influence1=f(0.6),
            phase_influence2=f(0.4),
            eccentricity1=f(0.6),
            eccentricity2=f(-0.2),
            fog=f(0.0),
            ambient=f(0.25),
        )

    def on(self, device) -> dict:
        """Every field as a float32 tensor on ``device``."""
        return {f.name: torch.as_tensor(np.asarray(getattr(self, f.name), np.float32),
                                        device=device)
                for f in dataclasses.fields(self)}


def _vec(v, like):
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def phase_rayleigh(cos_t):
    return 3.0 / (16.0 * math.pi) * (1.0 + cos_t * cos_t)


def phase_hg(cos_t, g):
    """Henyey-Greenstein phase function."""
    g2 = g * g
    return (1.0 - g2) / (4.0 * math.pi * (1.0 + g2 - 2.0 * g * cos_t) ** 1.5)


def _center_off(like):
    return _vec([0.0, EARTH_R, 0.0], like)  # the scene origin sits on the surface


def _ray_sphere_exit(p_pc, d, radius):
    """Distance to exit a sphere of ``radius`` around the planet centre from
    planet-centred position ``p_pc`` along direction ``d``."""
    b = (p_pc * d).sum(-1)
    c = (p_pc * p_pc).sum(-1) - radius ** 2
    disc = torch.clamp(b * b - c, min=0.0)
    return -b + torch.sqrt(disc)


def _length(v):
    return torch.sqrt(torch.clamp(m3.dot32(v, v), min=0.0))


def atmosphere(d, sun_dir, sun_intensity, *, steps: int = 16, light_steps: int = 4):
    """Single-scattered sky radiance for directions d (..., 3), and the
    view transmittance: a fixed-step march from the ground to the top of the
    atmosphere with a nested transmittance march toward the sun."""
    d = m3.normalize32(d)
    to_sun = -sun_dir
    cos_t = m3.dot32(d, to_sun)
    center = _center_off(d)
    beta_r, beta_m = _vec(BETA_R, d), _vec(BETA_M, d)

    cam_pc = center + _vec([0.0, 1.0, 0.0], d)
    t_exit = _ray_sphere_exit(cam_pc, d, EARTH_R + ATMOSPHERE_H)
    seg = t_exit / steps

    def optical_to_sun(p):
        p_pc = p + center
        te = _ray_sphere_exit(p_pc, to_sun.expand(p.shape), EARTH_R + ATMOSPHERE_H)
        ls = te / light_steps
        dr = torch.zeros(p.shape[:-1], device=d.device)
        dm = torch.zeros(p.shape[:-1], device=d.device)
        for i in range(light_steps):
            q_pc = p_pc + to_sun * ((i + 0.5) * ls)[..., None]
            hq = _length(q_pc) - EARTH_R
            dr = dr + torch.exp(-torch.clamp(hq, min=0.0) / H_R) * ls
            dm = dm + torch.exp(-torch.clamp(hq, min=0.0) / H_M) * ls
        return dr, dm

    acc_r = torch.zeros(d.shape[:-1] + (3,), device=d.device)
    acc_m = torch.zeros(d.shape[:-1] + (3,), device=d.device)
    od_r = torch.zeros(d.shape[:-1], device=d.device)
    od_m = torch.zeros(d.shape[:-1], device=d.device)
    for i in range(steps):
        t = (i + 0.5) * seg
        p = d * t[..., None]
        h = _length(p + center) - EARTH_R
        rho_r = torch.exp(-torch.clamp(h, min=0.0) / H_R)
        rho_m = torch.exp(-torch.clamp(h, min=0.0) / H_M)
        od_r = od_r + rho_r * seg
        od_m = od_m + rho_m * seg
        sr, sm = optical_to_sun(p)
        tau = beta_r * (od_r + sr)[..., None] + beta_m * 1.1 * (od_m + sm)[..., None]
        attn = torch.exp(-tau)
        acc_r = acc_r + attn * (rho_r * seg)[..., None]
        acc_m = acc_m + attn * (rho_m * seg)[..., None]
    color = sun_intensity * (acc_r * beta_r * phase_rayleigh(cos_t)[..., None]
                             + acc_m * beta_m * phase_hg(cos_t, 0.76)[..., None])
    return color, torch.exp(-(beta_r * od_r[..., None] + beta_m * od_m[..., None]))


def clouds(d, params: SkyParams, time=0.0, *, steps: int = 12):
    """Raymarched FBM cloud slab between CLOUD_START and CLOUD_END: (cloud
    colour (..., 3), transmittance (...,))."""
    p_ = params.on(d.device)
    d = m3.normalize32(d)
    up = torch.clamp(d[..., 1], min=1e-3)
    t0 = CLOUD_START / up
    t1 = CLOUD_END / up
    seg = (t1 - t0) / steps
    to_sun = -p_["sun_direction"]
    cos_t = m3.dot32(d, to_sun)
    phase = (p_["phase_influence1"] * phase_hg(cos_t, p_["eccentricity1"])
             + p_["phase_influence2"] * phase_hg(cos_t, p_["eccentricity2"]))
    if torch.is_tensor(time):  # the frame's clock, on the device
        zero = torch.zeros((), device=d.device)
        drift = torch.stack([time.to(d.device, torch.float32) * 0.005, zero, zero])
    else:
        drift = _vec([time * 0.005, 0.0, 0.0], d)

    def density(p, octaves: int = 5):
        q = p * 2.5e-4 + drift
        base = fbm3(q, octaves=octaves)
        cov = torch.clamp(base - (1.0 - p_["clouds_coverage"]), 0.0, 1.0)
        return cov * p_["clouds_density"]

    trans = torch.ones(d.shape[:-1], device=d.device)
    light = torch.zeros(d.shape[:-1], device=d.device)
    for i in range(steps):
        p = d * (t0 + (float(i) + 0.5) * seg)[..., None]
        rho = density(p)
        a = torch.exp(-rho * seg * p_["clouds_attenuation1"] * 1e-2)
        # secondary attenuation toward the sun: one 3-octave tap above
        rho_up = density(p + to_sun * 600.0, octaves=3)
        sun_t = torch.exp(-rho_up * p_["clouds_attenuation2"] * 10.0)
        light = light + trans * (1.0 - a) * sun_t
        trans = trans * a
    cloud_col = ((light * phase * 15.0 + (1.0 - trans) * p_["ambient"] * 0.5)[..., None]
                 * _vec([1.0, 1.0, 1.0], d))
    # horizon fade: clouds vanish at grazing angles
    fade = torch.clamp(d[..., 1] * 5.0, 0.0, 1.0)
    return cloud_col * fade[..., None], 1.0 - (1.0 - trans) * fade


def sun_disc(d, params: SkyParams, transmittance):
    p_ = params.on(d.device)
    cos_t = m3.dot32(m3.normalize32(d), -p_["sun_direction"])
    cos_r = torch.cos(torch.tensor(SUN_ANGULAR_R, dtype=torch.float32, device=d.device))
    disc = torch.clamp((cos_t - cos_r) / (1.0 - cos_r), 0.0, 1.0)
    limb = torch.sqrt(disc)  # soft limb darkening
    return (limb * p_["sun_intensity"] * 50.0)[..., None] * transmittance


STAR_CHUNK = 32768  # directions a (chunk, stars) product holds: 0.54 GB at 4,096 stars


def stars(d, star_dirs, star_colors, transmittance, *, sharpness: float = 8000.0,
          chunk: int = STAR_CHUNK):
    """Star field: a sum of narrow gaussian splats exp((cos - 1) * sharpness)
    around the catalogue's directions ``star_dirs`` (S, 3), weighted by
    ``star_colors`` (S, 3), as two products over the directions, ``chunk``
    rows at a time so that the (rows, S) weights stay small.

    A unit of cos's last place near 1 moves a weight by ~5e-4 relative, so
    the products must be float32: on the card TF32 (which loses ~1e-3 of
    cos) raises."""
    if d.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("sky.stars needs float32 products: "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    d = m3.normalize(d)
    flat = d.reshape(-1, 3)
    dirs_t = star_dirs.T.contiguous()
    col = torch.empty_like(flat)
    # one buffer for every chunk's weights, so that only one chunk is held
    w_buf = flat.new_empty((min(chunk, flat.shape[0]), dirs_t.shape[1]))
    for i in range(0, flat.shape[0], chunk):
        rows = flat[i:i + chunk]
        w = torch.matmul(rows, dirs_t, out=w_buf[:rows.shape[0]])
        w.sub_(1.0).mul_(sharpness).exp_()
        torch.matmul(w, star_colors, out=col[i:i + chunk])
    return col.reshape(d.shape) * transmittance


def sky_radiance(d, params: SkyParams, time=0.0, star_dirs=None, star_colors=None, *,
                 with_clouds: bool = True, with_stars: bool = False, with_sun: bool = True,
                 cloud_stride: int = 1, cloud_override=None):
    """Full sky for directions d (..., 3): atmosphere, clouds, sun disc,
    stars at night, and the ground fade below the horizon.

    ``cloud_stride``: on a 2-D ray grid (H, W, 3), march the clouds on every
    stride-th ray and upsample them. ``cloud_override``: precomputed
    (cloud colour, cloud transmittance) at d's resolution, used in place of
    the march. ``with_stars``: add ``stars`` of (``star_dirs``,
    ``star_colors``), scaled by the night factor clip(2 * sun_direction.y,
    0, 1), which is 0 while the sun is above the horizon; the term is
    skipped then (the sky parameters are host values)."""
    p_ = params.on(d.device)
    atm, trans = atmosphere(d, p_["sun_direction"], p_["sun_intensity"])
    color = atm
    cloud_t = torch.ones(d.shape[:-1], device=d.device)
    if cloud_override is not None:
        cl, cloud_t = cloud_override
        color = color * cloud_t[..., None] + cl
    elif with_clouds:
        if cloud_stride > 1 and d.dim() == 3:
            cl_q, ct_q = clouds(d[::cloud_stride, ::cloud_stride], params, time)
            cl = sampling.upsample_bilinear_pow2(cl_q, tuple(d.shape[:2]))
            cloud_t = sampling.upsample_bilinear_pow2(ct_q[..., None], tuple(d.shape[:2]))[..., 0]
        else:
            cl, cloud_t = clouds(d, params, time)
        color = color * cloud_t[..., None] + cl
    if with_sun:
        color = color + sun_disc(d, params, trans) * cloud_t[..., None]
    # the sun below the horizon (float32 on the host, as the reference's)
    night = float(np.clip(np.float32(params.sun_direction[1]) * np.float32(2.0), 0.0, 1.0))
    if with_stars and star_dirs is not None and night > 0.0:
        color = color + stars(d, star_dirs, star_colors, trans) * night * cloud_t[..., None]
    # ground fade below the horizon
    below = torch.clamp(-d[..., 1] * 10.0, 0.0, 1.0)[..., None]
    return color * (1.0 - below) + below * p_["ambient"] * _vec([0.2, 0.18, 0.16], d)
