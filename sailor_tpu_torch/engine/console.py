"""Console command dispatch (counterpart of sailor_tpu/engine/console.py,
the reference's stdin console, Runtime/Sailor.cpp:219-252): `scan`,
`stats.memory`, `world.save`, `refresh`, `capture`, `profile` and the
`<suite>.benchmark` commands (utils/benchmarks.py)."""

from __future__ import annotations

from typing import Callable

import torch

from sailor_tpu_torch.utils.log import SAILOR_LOG


class Console:
    def __init__(self, world=None, renderer=None, assets=None):
        self.world = world
        self.renderer = renderer
        self.assets = assets
        self.commands: dict[str, Callable[[list[str]], str]] = {}
        for name, fn in (("scan", self._cmd_scan), ("stats.memory", self._cmd_stats_memory),
                         ("world.save", self._cmd_world_save), ("refresh", self._cmd_refresh),
                         ("capture", self._cmd_capture), ("profile", self._cmd_profile)):
            self.register(name, fn)
        from sailor_tpu_torch.utils import benchmarks

        for name in benchmarks.ALL:
            self.register(f"{name}.benchmark",
                          lambda args, n=name: benchmarks.run(n, self._device()))
        self._mpool = None

    def register(self, name: str, fn: Callable[[list[str]], str]) -> None:
        self.commands[name] = fn

    def execute(self, line: str) -> str:
        parts = line.strip().split()
        if not parts:
            return ""
        cmd, args = parts[0], parts[1:]
        fn = self.commands.get(cmd)
        if fn is None:
            return f"unknown command '{cmd}' (try: {', '.join(sorted(self.commands))})"
        out = fn(args)
        SAILOR_LOG("console: %s -> %s", line.strip(), out.splitlines()[0] if out else "ok")
        return out

    def _cmd_scan(self, args) -> str:
        if self.assets is None:
            return "no asset registry"
        n = self.assets.scan_content_folder()
        reloaded = self.assets.check_hot_reload()
        return f"scanned {n} assets, hot-reloaded {len(reloaded)}"

    def _cmd_capture(self, args) -> str:
        """Arm a frame capture (F6): the renderer dumps the next frame."""
        if self.renderer is None or not hasattr(self.renderer, "capture"):
            return "no renderer attached"
        self.renderer.capture.trigger()
        return "capture armed for next frame"

    def _cmd_profile(self, args) -> str:
        """Per-node times of the current frame graph, slowest first."""
        if self.renderer is None or not hasattr(self.renderer, "profile_nodes"):
            return "no renderer attached"
        t = self.renderer.profile_nodes()
        if not t:
            return "no frame pushed yet"
        lines = [f"{name}: {ms:7.2f} ms" for name, ms in sorted(t.items(), key=lambda kv: -kv[1])]
        lines.append(f"TOTAL (sum of nodes): {sum(t.values()):.2f} ms")
        return "\n".join(lines)

    def _device(self):
        """The renderer's device, else the world's; None (the card) without
        either."""
        return getattr(self.renderer, "device", None) or getattr(self.world, "device", None)

    def _cmd_stats_memory(self, args) -> str:
        """Device memory in use, reserved, peak and total (the reference's
        stats.memory), the transform pool's occupancy and the native
        multipool's (TMultiPoolAllocator stats)."""
        from sailor_tpu_torch import native_bridge as nb

        lines = []
        dev = self._device()
        if dev is not None and dev.type == "cuda":
            s = torch.cuda.memory_stats(dev)
            total = torch.cuda.get_device_properties(dev).total_memory
            lines.append(
                f"{dev}: in_use={s.get('allocated_bytes.all.current', 0) / 1e6:.1f}MB "
                f"reserved={s.get('reserved_bytes.all.current', 0) / 1e6:.1f}MB "
                f"peak={s.get('allocated_bytes.all.peak', 0) / 1e6:.1f}MB "
                f"limit={total / 1e6:.1f}MB")
        elif dev is not None:
            lines.append(f"{dev}: (no device memory stats)")
        if self.world is not None:
            pool = self.world.transforms.pool
            lines.append(f"transform pool: {pool.num_alive}/{pool.capacity}")
        if self._mpool is None:
            self._mpool = nb.MultiPool()
        s = self._mpool.stats()
        lines.append(f"native multipool: {s['used']}/{s['capacity']} blocks, "
                     f"{s['pages']} pages, {s['reserved_bytes'] / 1e6:.1f}MB reserved")
        return "\n".join(lines)

    def _cmd_world_save(self, args) -> str:
        if self.world is None:
            return "no world"
        if not args:
            return "usage: world.save PATH"
        self.world.save(args[0])
        return f"saved {args[0]}"

    def _cmd_refresh(self, args) -> str:
        """F5: rescan the assets and rebuild the frame graph."""
        out = []
        if self.assets is not None:
            out.append(self._cmd_scan(args))
        if self.renderer is not None:
            self.renderer.refresh_frame_graph()
            out.append("frame graph refreshed")
        return "; ".join(out) or "nothing to refresh"
