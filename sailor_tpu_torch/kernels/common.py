"""Shared tiling helpers (counterpart of sailor_tpu/kernels/common.py)."""

from __future__ import annotations


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m
