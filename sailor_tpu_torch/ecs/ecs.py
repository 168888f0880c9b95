"""ECS core: System base class, ordered registry and SoA component pools
(counterpart of sailor_tpu/ecs/ecs.py, Runtime/ECS/ECS.h). A pool is a
dict of preallocated numpy arrays with a free list; a handle is an index.
"""

from __future__ import annotations

import numpy as np


class ComponentPool:
    """Fixed-capacity SoA pool with free-list handles; it doubles when full."""

    def __init__(self, fields: dict[str, tuple], capacity: int = 1024):
        self.capacity = capacity
        self.fields = {}
        for name, (shape, dtype, default) in fields.items():
            arr = np.zeros((capacity,) + shape, dtype)
            if default is not None:
                arr[:] = default
            self.fields[name] = arr
        self.alive = np.zeros(capacity, bool)
        self._free: list[int] = list(range(capacity - 1, -1, -1))

    def acquire(self) -> int:
        if not self._free:
            self._grow()
        idx = self._free.pop()
        self.alive[idx] = True
        return idx

    def release(self, idx: int) -> None:
        self.alive[idx] = False
        self._free.append(idx)

    def _grow(self):
        """Double the capacity. New slots are zero (not the field defaults),
        as in the reference."""
        new_cap = self.capacity * 2
        for name, arr in self.fields.items():
            grown = np.zeros((new_cap,) + arr.shape[1:], arr.dtype)
            grown[: self.capacity] = arr
            self.fields[name] = grown
        alive = np.zeros(new_cap, bool)
        alive[: self.capacity] = self.alive
        self.alive = alive
        self._free.extend(range(new_cap - 1, self.capacity - 1, -1))
        self.capacity = new_cap

    def __getattr__(self, name):
        fields = object.__getattribute__(self, "fields")
        if name in fields:
            return fields[name]
        raise AttributeError(name)

    @property
    def num_alive(self) -> int:
        return int(self.alive.sum())


class System:
    """Base system; subclasses set ``order`` and ``name`` and define tick."""

    order = 0
    name = "System"

    def __init__(self, world=None):
        self.world = world

    def begin_play(self) -> None:
        pass

    def tick(self, dt: float) -> None:
        pass

    def post_tick(self) -> None:
        pass

    def end_play(self) -> None:
        pass


class SystemRegistry:
    """Name -> System class registry (ECSFactory analog)."""

    _types: dict[str, type] = {}

    @classmethod
    def register(cls, system_cls: type) -> type:
        cls._types[system_cls.name] = system_cls
        return system_cls

    @classmethod
    def create_all(cls, world) -> list[System]:
        systems = [t(world) for t in cls._types.values()]
        systems.sort(key=lambda s: s.order)
        return systems

    @classmethod
    def types(cls) -> dict[str, type]:
        return dict(cls._types)
