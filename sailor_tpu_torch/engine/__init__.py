"""The engine: world, components, engine loop and console (counterpart of
sailor_tpu/engine/)."""

from sailor_tpu_torch.engine.world import Component, GameObject, World
from sailor_tpu_torch.engine import components  # noqa: F401 (registers component types)

__all__ = ["World", "GameObject", "Component", "components"]
