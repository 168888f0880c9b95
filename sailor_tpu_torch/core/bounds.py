"""Bounding volumes, frustum tests and ray intersections on tensors
(counterpart of sailor_tpu/core/bounds.py; Runtime/Math/Bounds.h).

Shapes: points (..., 3); AABBs as (min, max) pairs of (..., 3); spheres as
(..., 4) = (center, radius); planes as (..., 4) with n.x + d = 0 and the
normal pointing inside for frustum planes. Every function broadcasts over
leading dimensions and runs on the device of its inputs.

Rounding follows ``core.math3d``'s rule, the reference's form under
``jax.jit`` on a CPU: each dot is a chain of fused multiply-adds and a
cross product fuses its second product (``m3.dot``, ``m3.cross``), and a
length's root is taken in float64 and rounded once. So every float output
equals the jitted reference's bit for bit; the reference run op by op
(unfused) differs in the last bits.
"""

from __future__ import annotations

import math

import torch

from sailor_tpu_torch.core import math3d as m3


def _length(v):
    """|v| as (..., 1): the fused dot's root taken in float64 and rounded
    once (PyTorch's float32 sqrt on a CPU is not correctly rounded)."""
    return torch.sqrt(torch.clamp(m3.dot(v, v, keepdims=True), min=0.0).double()).float()


def _plane_distance(planes, x):
    """n . x + d for (..., P, 4) planes and (..., 3) points: the fused chain
    fma(n2, x2, fma(n1, x1, fma(n0, x0, d)))."""
    n64, x64 = planes[..., :3].double(), x[..., None, :].double()
    acc = planes[..., 3]
    for i in range(3):
        acc = m3._fma64(n64[..., i], x64[..., i], acc)
    return acc


# ---------------------------------------------------------------------------
# Planes & frustum
# ---------------------------------------------------------------------------


def plane_from_points(p0, p1, p2):
    """Plane through three points; normal = normalize(cross(p1-p0, p2-p0))
    (ComputePlane of the light-culling shader)."""
    n = m3.cross(p1 - p0, p2 - p0)
    n = n * torch.reciprocal(torch.clamp(_length(n), min=1e-12))
    d = -m3.dot(n, p0)
    return torch.cat([n, d[..., None]], dim=-1)


def normalize_plane(p):
    inv = torch.reciprocal(torch.clamp(_length(p[..., :3]), min=1e-12))
    return p * inv


def extract_frustum_planes(view_proj):
    """Six normalised frustum planes of a view-projection matrix
    (Gribb-Hartmann; Bounds.h ExtractFrustumPlanes): (..., 6, 4) ordered
    [left, right, bottom, top, near, far], normals pointing inward, clip
    depth in [0, 1]."""
    r = view_proj
    planes = torch.stack([
        r[..., 3, :] + r[..., 0, :],  # left
        r[..., 3, :] - r[..., 0, :],  # right
        r[..., 3, :] + r[..., 1, :],  # bottom
        r[..., 3, :] - r[..., 1, :],  # top
        r[..., 2, :],                 # near (z >= 0)
        r[..., 3, :] - r[..., 2, :],  # far (z <= w)
    ], dim=-2)
    return normalize_plane(planes)


def frustum_contains_sphere(planes, center, radius):
    """Sphere against a frustum: planes (..., 6, 4), center (..., 3), radius
    (...). True unless the sphere lies wholly outside a plane
    (Bounds.h ContainsSphere)."""
    dist = _plane_distance(planes, center)
    return torch.all(dist >= -radius[..., None], dim=-1)


def frustum_contains_aabb(planes, bmin, bmax):
    """AABB against a frustum by the p-vertex test; bool (...)."""
    n = planes[..., :3]
    p = torch.where(n >= 0.0, bmax[..., None, :], bmin[..., None, :])
    dist = m3.dot(n, p) + planes[..., 3]
    return torch.all(dist >= 0.0, dim=-1)


def sphere_overlaps_tile_frustum(center_vs, radius, planes4, z_near, z_far):
    """Light culling's test (SphereFrustumOverlaps): a view-space sphere
    (+z into the screen) against four side planes (..., 4, 4) and the
    [z_near, z_far] slab."""
    side = _plane_distance(planes4, center_vs)
    in_sides = torch.all(side >= -radius[..., None], dim=-1)
    z = center_vs[..., 2]
    in_depth = (z + radius >= z_near) & (z - radius <= z_far)
    return in_sides & in_depth


# ---------------------------------------------------------------------------
# AABB / sphere
# ---------------------------------------------------------------------------


def aabb_union(amin, amax, bmin, bmax):
    return torch.minimum(amin, bmin), torch.maximum(amax, bmax)


def aabb_center_extents(bmin, bmax):
    c = (bmin + bmax) * 0.5
    return c, bmax - c


def aabb_to_sphere(bmin, bmax):
    c, e = aabb_center_extents(bmin, bmax)
    return torch.cat([c, _length(e)], dim=-1)


def transform_aabb(m, bmin, bmax):
    """The AABB enclosing a (..., 4, 4)-transformed AABB (Arvo's method)."""
    c, e = aabb_center_extents(bmin, bmax)
    nc = m3.dot(m[..., :3, :3], c[..., None, :]) + m[..., :3, 3]
    ne = m3.dot(torch.abs(m[..., :3, :3]), e[..., None, :])
    return nc - ne, nc + ne


def ray_aabb(origin, inv_dir, bmin, bmax, t_max=math.inf):
    """Slab test; returns (hit, t_enter), broadcast over leading dims."""
    t0 = (bmin - origin) * inv_dir
    t1 = (bmax - origin) * inv_dir
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (tmax >= torch.clamp(tmin, min=0.0)) & (tmin < t_max)
    return hit, tmin


# ---------------------------------------------------------------------------
# Ray-triangle (Moller-Trumbore)
# ---------------------------------------------------------------------------


def ray_triangle(origin, direction, v0, v1, v2, eps: float = 1e-8):
    """Rays against triangles, broadcast over leading dims; returns
    (t, u, v, hit) (Math::IntersectRayTriangle, Bounds.h:188)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = m3.cross(direction, e2)
    det = m3.dot(e1, pvec)
    ok = torch.abs(det) > eps
    inv_det = torch.where(ok, 1.0 / det, torch.zeros_like(det))
    tvec = origin - v0
    u = m3.dot(tvec, pvec) * inv_det
    qvec = m3.cross(tvec, e1)
    v = m3.dot(direction, qvec) * inv_det
    t = m3.dot(e2, qvec) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps)
    return t, u, v, hit
