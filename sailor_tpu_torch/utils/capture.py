"""Frame capture (counterpart of sailor_tpu/utils/capture.py, the
RenderDocApi analog): arm once and the renderer dumps every target of the
next frame to a directory, PNGs for image-like targets and NPYs for the
rest, with a manifest.json of shapes, dtypes, value ranges and timings."""

from __future__ import annotations

import json
import os
import time

import numpy as np

from sailor_tpu_torch.utils.png import encode_png


def _host(arr):
    """A tensor (on any device) or array as a numpy array."""
    if hasattr(arr, "detach"):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


class FrameCapture:
    """Capture controller: ``trigger()`` arms it, and the renderer calls
    ``capture(targets, ...)`` on the next frame."""

    def __init__(self, out_dir: str = "Captures"):
        self.out_dir = out_dir
        self._armed = False
        self.num_captures = 0
        self.last_path: str | None = None

    def trigger(self) -> None:
        self._armed = True

    @property
    def armed(self) -> bool:
        return self._armed

    def capture(self, targets: dict, timings: dict | None = None,
                state: dict | None = None) -> str:
        """Dump one frame's targets. Returns the capture directory."""
        self._armed = False
        stamp = time.strftime("%Y%m%d_%H%M%S")
        path = os.path.join(self.out_dir, f"capture_{stamp}_{self.num_captures}")
        os.makedirs(path, exist_ok=True)
        manifest: dict = {"targets": {}, "timings": timings or {}}

        def dump(name: str, arr) -> None:
            try:
                a = _host(arr)
            except Exception:
                return
            if a.dtype == object or a.ndim == 0:
                return
            entry = {
                "shape": list(a.shape),
                "dtype": str(a.dtype),
                "min": float(np.nanmin(a)) if a.size else 0.0,
                "max": float(np.nanmax(a)) if a.size else 0.0,
            }
            safe = name.replace("/", "_")
            if a.ndim == 2 and a.dtype != np.int32:
                # scalar plane -> normalised grey PNG
                lo, hi = entry["min"], entry["max"]
                g = (a - lo) / (hi - lo) if hi > lo else np.zeros_like(a)
                u8 = np.repeat((np.clip(g, 0, 1) * 255).astype(np.uint8)[..., None], 3, -1)
                fn = f"{safe}.png"
                with open(os.path.join(path, fn), "wb") as f:
                    f.write(encode_png(u8))
            elif a.ndim == 3 and a.shape[-1] in (3, 4) and a.dtype != np.int32:
                rgb = np.clip(a[..., :3].astype(np.float32), 0.0, 1.0)
                fn = f"{safe}.png"
                with open(os.path.join(path, fn), "wb") as f:
                    f.write(encode_png((rgb * 255).astype(np.uint8)))
            else:
                fn = f"{safe}.npy"
                np.save(os.path.join(path, fn), a)
            entry["file"] = fn
            manifest["targets"][name] = entry

        for name, arr in targets.items():
            if name in ("state_out", "readback") or hasattr(arr, "keys"):
                continue
            if hasattr(arr, "shape"):
                dump(name, arr)
        for name, arr in (state or {}).items():
            if hasattr(arr, "shape"):
                dump(f"state/{name}", arr)

        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        self.num_captures += 1
        self.last_path = path
        return path
