"""RHI types: frame constants and the render-target registry (counterpart of
sailor_tpu/rhi/types.py, Runtime/RHI/Types.h)."""

from __future__ import annotations

import dataclasses

import torch

# channel count per texture format; every target is float32 in the port
FORMATS: dict[str, int] = {
    "R8_UNORM": 1,
    "R16_SFLOAT": 1,
    "R32_SFLOAT": 1,
    "R11G11B10_UFLOAT_PACK32": 3,
    "R16G16B16A16_SFLOAT": 4,
    "R32G32B32A32_SFLOAT": 4,
    "R8G8B8A8_SRGB": 4,
    "R8G8B8A8_UNORM": 4,
    "B8G8R8A8_SRGB": 4,
    "D32_SFLOAT": 1,
    "R16G16B16A16_BFLOAT": 4,
}


@dataclasses.dataclass
class FrameData:
    """Per-frame camera constants (parity: UboFrameData, RHI/Types.h:751-761)."""

    view: torch.Tensor              # (4, 4)
    projection: torch.Tensor        # (4, 4)
    inv_projection: torch.Tensor    # (4, 4)
    camera_position: torch.Tensor   # (3,)
    camera_z_near_far: torch.Tensor  # (2,)
    current_time: torch.Tensor      # scalar
    delta_time: torch.Tensor        # scalar

    @property
    def view_projection(self):
        return self.projection @ self.view

    @classmethod
    def create(cls, view, projection, camera_position, z_near, z_far,
               time=0.0, dt=0.0):
        dev = view.device
        f32 = dict(dtype=torch.float32, device=dev)
        return cls(
            view=view,
            projection=projection,
            inv_projection=torch.linalg.inv(projection),
            camera_position=camera_position,
            camera_z_near_far=torch.tensor([z_near, z_far], **f32),
            current_time=torch.tensor(time, **f32),
            delta_time=torch.tensor(dt, **f32),
        )


def _eval_size_expr(expr: str, original) -> int:
    """Evaluate a size expression with + - * / and parentheses only
    (never eval(): a content file must not run code)."""
    tokens: list = []
    i, n = 0, len(expr)
    while i < n:
        c = expr[i]
        if c.isspace():
            i += 1
        elif c.isdigit():
            j = i
            while j < n and expr[j].isdigit():
                j += 1
            tokens.append(int(expr[i:j]))
            i = j
        elif c in "+-*/()":
            tokens.append(c)
            i += 1
        else:
            raise ValueError(f"bad size expression: {original!r}")
    pos = [0]

    def peek():
        return tokens[pos[0]] if pos[0] < len(tokens) else None

    def take():
        t = peek()
        pos[0] += 1
        return t

    def atom():
        t = take()
        if t == "(":
            v = add()
            if take() != ")":
                raise ValueError(f"bad size expression: {original!r}")
            return v
        if t == "-":
            return -atom()
        if isinstance(t, int):
            return t
        raise ValueError(f"bad size expression: {original!r}")

    def mul():
        v = atom()
        while peek() in ("*", "/"):
            if take() == "*":
                v = v * atom()
            else:
                d = atom()
                if d == 0:
                    raise ValueError(f"division by zero in size: {original!r}")
                v = v // d
        return v

    def add():
        v = mul()
        while peek() in ("+", "-"):
            v = v + mul() if take() == "+" else v - mul()
        return v

    out = add()
    if pos[0] != len(tokens):
        raise ValueError(f"bad size expression: {original!r}")
    if not (0 < out <= 16384 * 16384):
        raise ValueError(f"size out of range: {original!r} -> {out}")
    return int(out)


@dataclasses.dataclass(frozen=True)
class TargetSpec:
    """Declarative render-target spec parsed from `.renderer` YAML."""

    name: str
    format: str = "R16G16B16A16_SFLOAT"
    width: int | str = "ViewportWidth"    # int or size expression
    height: int | str = "ViewportHeight"
    mips: int = 1
    clear: tuple = (0.0, 0.0, 0.0, 0.0)

    def resolve_size(self, viewport_w: int, viewport_h: int) -> tuple[int, int]:
        def resolve(v):
            if isinstance(v, int):
                return v
            expr = str(v).replace("ViewportWidth", str(viewport_w)).replace(
                "ViewportHeight", str(viewport_h))
            return _eval_size_expr(expr, v)

        return resolve(self.width), resolve(self.height)


class RenderTargets:
    """Allocates the named render targets of a frame graph on one device."""

    def __init__(self, viewport_w: int, viewport_h: int, device):
        self.viewport = (viewport_w, viewport_h)
        self.device = device
        self.specs: dict[str, TargetSpec] = {}

    def declare(self, spec: TargetSpec) -> None:
        if spec.format not in FORMATS:
            raise ValueError(f"unknown target format {spec.format!r}")
        self.specs[spec.name] = spec

    def allocate(self) -> dict[str, torch.Tensor]:
        out = {}
        for name, spec in self.specs.items():
            w, h = spec.resolve_size(*self.viewport)
            ch = FORMATS[spec.format]
            shape = (h, w, ch) if ch > 1 else (h, w)
            fill = torch.tensor(spec.clear[:ch] if ch > 1 else spec.clear[0],
                                dtype=torch.float32, device=self.device)
            out[name] = fill.expand(shape).clone()
            for m in range(1, spec.mips):
                mw, mh = max(1, w >> m), max(1, h >> m)
                mshape = (mh, mw, ch) if ch > 1 else (mh, mw)
                out[f"{name}/mip{m}"] = torch.zeros(
                    mshape, dtype=torch.float32, device=self.device)
        return out
