"""Baked particle animations (counterpart of sailor_tpu/assets/particles.py;
ParticlesNode.h:18-52 ParticleInfo + ParticleData analog).

The reference plays pre-baked particle simulations: a YAML header
(fps / frames / n / traceDecay / traceFrames) plus a binary blob of
per-frame `ParticleData` records — each record carries TWO states
(pos1/color1/size1 -> pos2/color2/size2) that the compute shader
interpolates across the frame interval (old state drives the motion
trail). Here the asset is a `.particles` YAML header next to a `.bin`
float32 blob of shape (frames, n, 20), field order matching the
reference struct:

  [enabled, size1, size2, _pad, x1, y1, z1, _w, r1, g1, b1, a1,
                                x2, y2, z2, _w, r2, g2, b2, a2]

Playback interpolates state1 -> state2 by the sub-frame phase on the
tensors' device (one gather of a frame row + lerp) — no host work per
frame. Files are byte-compatible with the reference's in both directions.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import yaml

RECORD = 20  # floats per ParticleData record


@dataclass
class ParticlesAsset:
    fps: int
    frames: int
    n: int
    trace_decay: float
    trace_frames: int
    data: np.ndarray  # (frames, n, RECORD) float32

    @classmethod
    def load(cls, path: str) -> "ParticlesAsset":
        with open(path) as f:
            head = yaml.safe_load(f)
        binary = head.get("binary", os.path.splitext(path)[0] + ".bin")
        if not os.path.isabs(binary):
            binary = os.path.join(os.path.dirname(path), binary)
        frames, n = int(head["frames"]), int(head["n"])
        data = np.fromfile(binary, dtype=np.float32)
        if data.size != frames * n * RECORD:
            raise ValueError(
                f"{binary}: expected {frames}x{n}x{RECORD} floats, "
                f"got {data.size}"
            )
        return cls(
            fps=int(head.get("fps", 30)),
            frames=frames,
            n=n,
            trace_decay=float(head.get("traceDecay", 0.0)),
            trace_frames=int(head.get("traceFrames", 1)),
            data=data.reshape(frames, n, RECORD),
        )

    def save(self, path: str) -> None:
        binary = os.path.splitext(path)[0] + ".bin"
        with open(path, "w") as f:
            yaml.safe_dump(
                {
                    "fps": self.fps, "frames": self.frames, "n": self.n,
                    "traceDecay": self.trace_decay,
                    "traceFrames": self.trace_frames,
                    "binary": os.path.basename(binary),
                },
                f,
            )
        self.data.astype(np.float32).tofile(binary)


def sample_baked(data, t, fps: int, frames: int):
    """Playback on the tensors' device: baked (frames, n, RECORD) tensor ->
    particle state at time ``t`` (a 0-d tensor or a float). Returns
    (positions (n, 3), radii (n,), colors (n, 4)); disabled records get
    alpha 0.

    Interpolation matches the reference compute path: pick the frame row
    by floor(t * fps) (looped), then lerp state1 -> state2 by the
    sub-frame phase.
    """
    import torch

    from sailor_tpu_torch.core.math3d import fma

    t = torch.as_tensor(t, dtype=torch.float32, device=data.device)
    f = t * fps
    fl = torch.floor(f)
    i0 = torch.remainder(fl.to(torch.int32), frames)
    a = f - fl
    b = 1.0 - a
    row = data[i0.long()]  # (n, RECORD) — one small gather

    def lerp(s1, s2):  # s1 * (1 - a) + s2 * a, fused as the reference compiles it
        return fma(s1, b, s2 * a)

    enabled = row[:, 0] > 0.5
    size = lerp(row[:, 1], row[:, 2])
    pos = lerp(row[:, 4:7], row[:, 12:15])
    col = lerp(row[:, 8:12], row[:, 16:20])
    col[:, 3] = torch.where(enabled, col[:, 3], torch.zeros_like(col[:, 3]))
    return pos, size, col


def bake_fountain(
    frames: int = 90, n: int = 192, fps: int = 30, seed: int = 3,
    origin=(0.0, 0.2, 0.0), speed: float = 5.0, life: float = 1.6,
    trace_decay: float = 0.82, trace_frames: int = 6,
) -> ParticlesAsset:
    """Bake a looping fountain sim into the reference record format —
    stands in for the reference's offline-baked content (none is checked
    into the reference repo either); also the test fixture."""
    rng = np.random.default_rng(seed)
    dt = 1.0 / fps
    dur = frames * dt
    birth = rng.uniform(0.0, dur, n).astype(np.float32)
    ang = rng.uniform(0, 2 * np.pi, n)
    tilt = rng.uniform(0.0, 0.35, n)
    v0 = np.stack(
        [np.sin(ang) * tilt, np.ones(n), np.cos(ang) * tilt], 1
    ).astype(np.float32)
    v0 *= speed * rng.uniform(0.8, 1.2, n)[:, None].astype(np.float32)
    g = np.asarray([0.0, -9.8, 0.0], np.float32)
    warm = rng.uniform(0.0, 1.0, n).astype(np.float32)

    def state(tt):
        """Particle state at absolute time tt (n,) -> pos/size/color."""
        age = np.mod(tt - birth, life * np.ones(1, np.float32))
        # particles loop on their own life cycle; hide those born "later
        # in the loop" only during the lead-in (looped anyway)
        p = np.asarray(origin, np.float32) + v0 * age[:, None] \
            + 0.5 * g * (age ** 2)[:, None]
        fade = np.clip(1.0 - age / life, 0.0, 1.0).astype(np.float32)
        size = (0.06 + 0.10 * (1.0 - fade)).astype(np.float32)
        col = np.stack(
            [3.0 + 2.0 * warm, 1.6 + 1.2 * warm, 0.7 + 0.4 * warm,
             fade], 1
        ).astype(np.float32)
        return p, size, col

    data = np.zeros((frames, n, RECORD), np.float32)
    for fidx in range(frames):
        t1 = fidx * dt
        t2 = (fidx + 1) * dt
        p1, s1, c1 = state(np.full(n, t1, np.float32))
        p2, s2, c2 = state(np.full(n, t2, np.float32))
        data[fidx, :, 0] = 1.0
        data[fidx, :, 1] = s1
        data[fidx, :, 2] = s2
        data[fidx, :, 4:7] = p1
        data[fidx, :, 8:12] = c1
        data[fidx, :, 12:15] = p2
        data[fidx, :, 16:20] = c2
    return ParticlesAsset(
        fps=fps, frames=frames, n=n, trace_decay=trace_decay,
        trace_frames=trace_frames, data=data,
    )
