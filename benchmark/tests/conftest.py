"""Shared small sizes for the benchmark's CPU tests, and the card check of
the tests marked ``cuda`` (decided in a fixture, never at import)."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the cells at sizes a CPU test run holds; the port runs its plain twins
SMALL = {
    "queues-1080p.still": {
        "scene_args": {"width": 128, "height": 64, "point_lights": 24, "objects": 6,
                       "sphere_rings": 8, "sphere_sectors": 16, "texture_size": 32},
        "settings": {"shadow_resolution": 128}},
    "tracer-512.pooled": {
        "scene_args": {"width": 32, "height": 32, "spheres": 2, "rings": 6, "sectors": 12},
        "render": {"spp": 4},  # one pass of 4 samples
        "traffic": {"sample_batch": 4, "judged_slots": 64, "judged_rays": 128,
                    "warmup_renders": 1}},
}


def pytest_configure(config):
    import torch

    torch.set_num_threads(2)  # several test workers share the cores


def small(workload):
    return copy.deepcopy(SMALL[workload])


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card")
    return torch.device("cuda")
