"""Host meshes (numpy) for the benchmark's scene recipes.

The same vertex layouts and winding as the port's ``assets/primitives``
(a ground plane, cubes and UV spheres merged into one soup), written out
here so that the inputs of a cell do not depend on the code under test.
"""

from __future__ import annotations

import math

import numpy as np


def _mesh(pos, nrm, uv, idx):
    pos = np.asarray(pos, np.float32)
    return {"position": pos, "normal": np.asarray(nrm, np.float32),
            "uv": np.asarray(uv, np.float32),
            "color": np.ones((len(pos), 4), np.float32),
            "indices": np.asarray(idx, np.int32)}


def plane(size: float) -> dict:
    """XZ ground plane facing +Y, counter-clockwise seen from above."""
    s = size * 0.5
    return _mesh([[-s, 0, -s], [s, 0, -s], [s, 0, s], [-s, 0, s]], [[0, 1, 0]] * 4,
                 [[0, 0], [1, 0], [1, 1], [0, 1]], [[0, 2, 1], [0, 3, 2]])


def cube(size: float) -> dict:
    s = size * 0.5
    faces = [
        ([0, 0, 1], [[-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s]]),
        ([0, 0, -1], [[s, -s, -s], [-s, -s, -s], [-s, s, -s], [s, s, -s]]),
        ([1, 0, 0], [[s, -s, s], [s, -s, -s], [s, s, -s], [s, s, s]]),
        ([-1, 0, 0], [[-s, -s, -s], [-s, -s, s], [-s, s, s], [-s, s, -s]]),
        ([0, 1, 0], [[-s, s, s], [s, s, s], [s, s, -s], [-s, s, -s]]),
        ([0, -1, 0], [[-s, -s, -s], [s, -s, -s], [s, -s, s], [-s, -s, s]]),
    ]
    pos, nrm, uv, idx = [], [], [], []
    for n, corners in faces:
        base = len(pos)
        pos.extend(corners)
        nrm.extend([n] * 4)
        uv.extend([[0, 0], [1, 0], [1, 1], [0, 1]])
        idx.extend([[base, base + 1, base + 2], [base, base + 2, base + 3]])
    return _mesh(pos, nrm, uv, idx)


def uv_sphere(radius: float, rings: int, sectors: int) -> dict:
    pos, nrm, uv, idx = [], [], [], []
    for r in range(rings + 1):
        theta = math.pi * r / rings
        for s in range(sectors + 1):
            phi = 2 * math.pi * s / sectors
            n = [math.sin(theta) * math.cos(phi), math.cos(theta),
                 math.sin(theta) * math.sin(phi)]
            pos.append([radius * c for c in n])
            nrm.append(n)
            uv.append([s / sectors, r / rings])
    stride = sectors + 1
    for r in range(rings):
        for s in range(sectors):
            a = r * stride + s
            b = a + stride
            idx.append([a, a + 1, b])
            idx.append([a + 1, b + 1, b])
    return _mesh(pos, nrm, uv, idx)


def merge(meshes_and_transforms, material_ids) -> dict:
    """One soup from (mesh, 4x4 model matrix) pairs; triangle i of mesh k
    takes ``material_ids[k]``."""
    out = {k: [] for k in ("position", "normal", "uv", "color", "indices", "material_id")}
    offset = 0
    for (mesh, model), mat in zip(meshes_and_transforms, material_ids):
        m = np.asarray(model, np.float32)
        p = mesh["position"] @ m[:3, :3].T + m[:3, 3]
        n = mesh["normal"] @ np.linalg.inv(m[:3, :3]).astype(np.float32)
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
        out["position"].append(p)
        out["normal"].append(n)
        out["uv"].append(mesh["uv"])
        out["color"].append(mesh["color"])
        out["indices"].append(mesh["indices"] + offset)
        out["material_id"].append(np.full(len(mesh["indices"]), mat, np.int32))
        offset += len(p)
    soup = {k: np.concatenate(v) for k, v in out.items()}
    for k in ("position", "normal", "uv", "color"):
        soup[k] = soup[k].astype(np.float32)
    return soup


def look_at(eye, center, up) -> np.ndarray:
    """Right-handed view matrix (float32) from eye toward center."""
    eye, center, up = (np.asarray(x, np.float64) for x in (eye, center, up))
    f = center - eye
    f /= np.linalg.norm(f)
    s = np.cross(f, up)
    s /= np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4)
    m[0, :3], m[0, 3] = s, -s @ eye
    m[1, :3], m[1, 3] = u, -u @ eye
    m[2, :3], m[2, 3] = -f, f @ eye
    return m.astype(np.float32)


def perspective(fov_y: float, aspect: float, near: float, far: float) -> np.ndarray:
    """Reverse-Z perspective (near at depth 1, far at 0), clip z in [0, 1]."""
    f = 1.0 / math.tan(fov_y / 2)
    m = np.zeros((4, 4))
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = near / (far - near)
    m[2, 3] = far * near / (far - near)
    m[3, 2] = -1.0
    return m.astype(np.float32)
