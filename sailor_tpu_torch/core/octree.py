"""Loose octree (counterpart of sailor_tpu/core/octree.py;
Runtime/Containers/Octree.h TOctree).

The reference uses octrees for CPU-side scene culling (StaticMeshRendererECS
keeps stationary/static proxy octrees; SceneView::TraceScene frustum-queries
them). The port culls each frame on the device in dense math, so this host
container serves the CPU's roles: editor picking, broad-phase queries and
world streaming decisions. Numpy-backed, loose-bounds variant (children
overlap by ``looseness``) so elements never straddle nodes. The port keeps
its own copy of the reference's module, line for line in its logic.
"""

from __future__ import annotations

import numpy as np


class Octree:
    def __init__(self, center=(0, 0, 0), size: float = 100.0,
                 max_depth: int = 8, max_elements: int = 8,
                 looseness: float = 2.0):
        self.center = np.asarray(center, np.float32)
        self.size = float(size)
        self.max_depth = max_depth
        self.max_elements = max_elements
        self.looseness = looseness
        self.root = _Node(self.center, self.size)
        self._where: dict = {}  # element id -> node
        self.num_elements = 0

    # -- mutation (TOctree Insert/Remove/Update) -------------------------------

    def insert(self, key, bmin, bmax) -> bool:
        bmin = np.asarray(bmin, np.float32)
        bmax = np.asarray(bmax, np.float32)
        node = self._find_node(self.root, bmin, bmax, 0)
        if node is None:
            return False
        node.elements[key] = (bmin, bmax)
        self._where[key] = node
        self.num_elements += 1
        self._maybe_split(node)
        return True

    def remove(self, key) -> bool:
        node = self._where.pop(key, None)
        if node is None:
            return False
        node.elements.pop(key, None)
        self.num_elements -= 1
        return True

    def update(self, key, bmin, bmax) -> bool:
        self.remove(key)
        return self.insert(key, bmin, bmax)

    # -- queries (SceneView::TraceScene analog) ----------------------------------

    def query_aabb(self, qmin, qmax) -> list:
        """All keys whose bounds overlap [qmin, qmax]."""
        qmin = np.asarray(qmin, np.float32)
        qmax = np.asarray(qmax, np.float32)
        out = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            half = n.size * 0.5 * self.looseness
            if ((n.center - half > qmax) | (n.center + half < qmin)).any():
                continue
            for k, (bmin, bmax) in n.elements.items():
                if not ((bmin > qmax) | (bmax < qmin)).any():
                    out.append(k)
            stack.extend(n.children)
        return out

    def query_frustum(self, planes) -> list:
        """Keys whose bounds intersect the frustum (planes (6, 4), inward
        normals — Math::Frustum::OverlapsAABB parity)."""
        planes = np.asarray(planes, np.float32)
        out = []
        stack = [self.root]
        while stack:
            n = stack.pop()
            half = n.size * 0.5 * self.looseness
            if not _aabb_in_frustum(planes, n.center - half, n.center + half):
                continue
            for k, (bmin, bmax) in n.elements.items():
                if _aabb_in_frustum(planes, bmin, bmax):
                    out.append(k)
            stack.extend(n.children)
        return out

    # -- internals ------------------------------------------------------------------

    def _fits(self, node, bmin, bmax) -> bool:
        half = node.size * 0.5 * self.looseness
        return bool(
            ((bmin >= node.center - half) & (bmax <= node.center + half)).all()
        )

    def _find_node(self, node, bmin, bmax, depth):
        if not self._fits(node, bmin, bmax):
            return node if node is self.root else None
        for c in node.children:
            if self._fits(c, bmin, bmax) and _child_of(c, bmin, bmax):
                return self._find_node(c, bmin, bmax, depth + 1)
        return node

    def _maybe_split(self, node):
        depth = 0
        n = node
        while n.parent is not None:
            depth += 1
            n = n.parent
        if len(node.elements) <= self.max_elements or node.children or depth >= self.max_depth:
            return
        q = node.size * 0.25
        for dx in (-q, q):
            for dy in (-q, q):
                for dz in (-q, q):
                    c = _Node(node.center + [dx, dy, dz], node.size * 0.5)
                    c.parent = node
                    node.children.append(c)
        # redistribute
        for k, (bmin, bmax) in list(node.elements.items()):
            for c in node.children:
                if self._fits(c, bmin, bmax):
                    node.elements.pop(k)
                    c.elements[k] = (bmin, bmax)
                    self._where[k] = c
                    break


class _Node:
    __slots__ = ("center", "size", "elements", "children", "parent")

    def __init__(self, center, size):
        self.center = np.asarray(center, np.float32)
        self.size = float(size)
        self.elements = {}
        self.children = []
        self.parent = None


def _child_of(node, bmin, bmax) -> bool:
    c = (bmin + bmax) * 0.5
    half = node.size * 0.5
    return bool((np.abs(c - node.center) <= half).all())


def _aabb_in_frustum(planes, bmin, bmax) -> bool:
    n = planes[:, :3]
    p = np.where(n >= 0, bmax, bmin)
    dist = (n * p).sum(-1) + planes[:, 3]
    return bool((dist >= 0).all())
