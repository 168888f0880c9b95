"""ECS: struct-of-arrays component systems (counterpart of sailor_tpu/ecs/).

The pools are host numpy arrays (cheap in-place edits from gameplay code);
the transform hierarchy is resolved on the host in float32 and only what a
frame draws (the instances' matrices, the light table, the camera's
constants) goes to the device once a frame.
"""

from sailor_tpu_torch.ecs.ecs import System, SystemRegistry
from sailor_tpu_torch.ecs.transform import TransformSystem
from sailor_tpu_torch.ecs.camera import CameraSystem
from sailor_tpu_torch.ecs.lighting import LightingSystem
from sailor_tpu_torch.ecs.static_mesh import StaticMeshSystem

__all__ = [
    "System", "SystemRegistry", "TransformSystem", "CameraSystem",
    "LightingSystem", "StaticMeshSystem",
]
