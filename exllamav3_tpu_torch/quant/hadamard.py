"""Hadamard rotations in torch (counterpart of exllamav3_tpu/quant/hadamard.py).

EXL3 rotates both sides of every weight with blockwise 128-point Sylvester
Hadamards scaled by 1/sqrt(128). Only the power-of-two construction is
ported; the Paley sizes serve other architectures and wait.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

HAD_K = 128
HAD_N = 128


@lru_cache(maxsize=16)
def hadamard_np(n: int) -> np.ndarray:
    """Sylvester Hadamard matrix of size n (a power of two), float32 +-1."""
    if n < 1 or n & (n - 1):
        raise ValueError(f"no Sylvester Hadamard of size {n}")
    h = np.ones((1, 1), dtype=np.float32)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]]).astype(np.float32)
    return h


@lru_cache(maxsize=64)
def _hadamard_scaled(n: int, device: str) -> torch.Tensor:
    return torch.from_numpy(hadamard_np(n) / math.sqrt(n)).to(device)


def hadamard_scaled(n: int, device=None) -> torch.Tensor:
    """H_n / sqrt(n) as float32 on `device`; one copy per size and device is
    kept, so a call on the card costs no host-to-device copy after the first."""
    return _hadamard_scaled(n, str(torch.device(device or "cpu")))


def had_right(x: torch.Tensor, scale_pre=None, scale_post=None, block: int = 128) -> torch.Tensor:
    """y = (x * scale_pre).view(..., -1, block) @ (H/sqrt(block)) * scale_post,
    computed in f32 and returned in x's dtype."""
    h = hadamard_scaled(block, x.device)
    xf = x.to(torch.float32)
    if scale_pre is not None:
        xf = xf * scale_pre.to(torch.float32)
    shp = xf.shape
    yf = (xf.reshape(*shp[:-1], shp[-1] // block, block) @ h).reshape(shp)
    if scale_post is not None:
        yf = yf * scale_post.to(torch.float32)
    return yf.to(x.dtype)


def had_left(w: torch.Tensor, block: int = 128) -> torch.Tensor:
    """(H/sqrt(block)) @ w applied to row blocks of a (k, n) f32 matrix."""
    k, n = w.shape
    h = hadamard_scaled(block, w.device)
    return (h @ w.reshape(k // block, block, n)).reshape(k, n)
