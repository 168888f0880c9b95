"""One run of one cell: set-up, the measured (or traced) window, the
device's peak, the program's state freed, the check against the plain
reference, the import guard, and the result line."""

from __future__ import annotations

import json
import os
import sys
import time

from benchmark.harness import guard, manifest

_T0 = time.perf_counter()


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def _metric(value, unit):
    return {"value": value, "unit": unit}


def run(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        overrides: dict | None = None, control: bool = False) -> dict:
    """The result of one run, as the line the benchmark prints (the
    comparisons under "compared"); with ``control`` also the numbers of
    the control, the reference in bfloat16 in the program's place, under
    "control_bf16" (the benchmark's own runs never ask for it)."""
    import torch

    cell = manifest.cell(name)
    for part, values in (overrides or {}).items():  # smaller sizes for the CPU tests
        (cell.traffic if part == "traffic" else cell.config[part]).update(values)
    drv = cell.driver()
    s = drv.setup(cell, seed, device)
    setup_s = process_age_s()
    if trace:
        tr, res = drv.traced_run(s, seconds)
    else:
        res = drv.window_run(s, seconds)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    drv.release(s)
    if cuda:
        torch.cuda.empty_cache()
    check = cell.check()
    settings = cell.config.get("settings", {})
    numbers = check.judge(s.capture, s.host, device, settings)
    compared = {k: {"value": numbers[k], "limit": check.LIMITS[k]} for k in check.LIMITS}
    correct = all(v["value"] <= v["limit"] for v in compared.values())
    metrics = {}
    if trace:
        for m in cell.per_layer:
            value = cell.reader(m["name"]).read(tr, s)
            if value is not None:
                metrics[m["name"]] = _metric(value, m["unit"])
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = _metric(setup_s, m["unit"])
            else:
                metrics[m["name"]] = _metric(res["metrics"][m["name"]], m["unit"])
    out = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                      "count": 1, "memory_peak_bytes": peak}}
    if trace:
        out["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    if control:
        out["control_bf16"] = check.control(s.capture, s.host, device, settings)
    out["compared"] = compared
    return out


def _built_now():
    """Seconds the port spent building and loading its CUDA library, if
    it compiled it in this process (its compiler log is then set), else
    None."""
    lib = sys.modules.get("sailor_tpu_torch.kernels.cuda_lib")
    if lib is None or not getattr(lib, "build_log", ""):
        return None
    return lib.build_seconds


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    import torch

    need = int(manifest.cell(a.workload).workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"benchmark: needs {need} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    leaning = guard.reference_imports()
    if leaning:
        print("benchmark: the reference imports " + ", ".join(leaning), file=sys.stderr)
        return 3
    out = run(a.workload, a.seed, a.seconds, bool(a.trace))
    built = _built_now()
    if built is not None:
        print(f"benchmark: this run built the CUDA library ({built:.1f} s): a first run",
              file=sys.stderr)
    bad = guard.loaded()
    if bad:
        print("benchmark: the run loaded " + ", ".join(bad), file=sys.stderr)
        return 3
    for k, v in out["compared"].items():
        print(f"compared {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(out))
    return 0
