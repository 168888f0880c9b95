"""Prefabs (counterpart of sailor_tpu/engine/prefab.py,
Runtime/AssetRegistry/Prefab/): a game object's subtree as a YAML
document, instantiated into any world with fresh instance ids and
two-phase parent resolution."""

from __future__ import annotations

import numpy as np

from sailor_tpu_torch.engine.world import GameObject, World, _instantiate_entries


def _subtree(world: World, root: GameObject) -> list[GameObject]:
    out = [root]
    frontier = {root}
    changed = True
    while changed:
        changed = False
        for go in world.game_objects:
            if go not in frontier and go.parent in frontier:
                out.append(go)
                frontier.add(go)
                changed = True
    return out


def from_game_object(root: GameObject) -> dict:
    """Serialize the root and its descendants (Prefab::FromGameObject)."""
    objs = _subtree(root.world, root)
    index = {go: i for i, go in enumerate(objs)}
    entries = [{
        "name": go.name,
        "position": go.position.tolist(),
        "rotation": go.rotation.tolist(),
        "scale": go.scale.tolist(),
        "parentIndex": index.get(go.parent, -1) if go is not root else -1,
        "components": [c.serialize() for c in go.components],
    } for go in objs]
    return {"prefab": root.name, "gameObjects": entries}


def save(root: GameObject, path: str) -> None:
    import yaml

    with open(path, "w") as f:
        yaml.safe_dump(from_game_object(root), f, sort_keys=False)


def instantiate(world: World, doc: dict | str, parent: GameObject | None = None,
                position=None, assets=None) -> GameObject:
    """Instantiate a prefab document (or a path to one) into the world and
    return the new root: fresh instance ids, optional parent and position."""
    if isinstance(doc, str):
        import yaml

        with open(doc) as f:
            doc = yaml.safe_load(f)
    gos = _instantiate_entries(world, doc.get("gameObjects", []) or [], False, assets)
    root = gos[0] if gos else world.instantiate("Prefab")
    if parent is not None:
        root.set_parent(parent)
    if position is not None:
        root.position = np.asarray(position, np.float32)
    return root
