"""EXL3 trellis bit-stream layout in torch (counterpart of exllamav3_tpu/quant/trellis.py).

A 16x16 weight tile is a circular bit stream of 256*K bits, stored MSB-first
in 16-bit halfwords with each pair swapped so that a little-endian uint32
read gives stream order. Code t is the 16-bit window ending at bit
(t+1)*K (mod 256K). File tensor shape: (tiles_k, tiles_n, 16*K) int16, whose
halfwords are read as unsigned (& 0xFFFF).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache
def _tile_perm_np() -> np.ndarray:
    perm = np.empty(256, dtype=np.int32)
    for g in range(32):
        r = (g % 4) * 2
        c = g // 4
        rows = (r, r + 1, r + 8, r + 9)
        for ci, cc in enumerate((c, c + 8)):
            for ri, rr in enumerate(rows):
                perm[g * 8 + ci * 4 + ri] = rr * 16 + cc
    return perm


def tile_perm() -> torch.Tensor:
    """Sequence order -> row-major tile index map (256,) int64."""
    return torch.from_numpy(_tile_perm_np().astype(np.int64))


def tile_perm_inverse() -> torch.Tensor:
    """Row-major tile index -> sequence position (256,) int64."""
    return torch.from_numpy(np.argsort(_tile_perm_np()).astype(np.int64))


@lru_cache
def _unpack_indices(K: int):
    nw = 8 * K
    t = np.arange(256)
    end = (t + 1) * K
    end = np.where(end < 16, end + 256 * K, end)  # circular wrap
    i_last = (end - 1) // 32 % nw
    i_prev = (i_last - 1) % nw
    sh = 32 * ((end - 1) // 32 + 1) - end  # 0..31
    return (torch.from_numpy(i_prev.astype(np.int64)),
            torch.from_numpy(i_last.astype(np.int64)),
            torch.from_numpy(sh.astype(np.int64)))


def unpack_trellis(packed: torch.Tensor, K: int) -> torch.Tensor:
    """(..., 16K) int16 halfwords -> (..., 256) int64 codes (0..65535)."""
    assert packed.shape[-1] == 16 * K, packed.shape
    u = packed.to(torch.int64) & 0xFFFF
    words = (u[..., 1::2] << 16) | u[..., 0::2]  # uint32 stream words
    i_prev, i_last, sh = (t.to(packed.device) for t in _unpack_indices(K))
    a = words[..., i_prev]
    b = words[..., i_last]
    # funnel shift (a:b) >> sh; only the low 16 bits are kept, so the int64
    # wrap of a << 32 (sh == 0) cannot reach them
    return ((a << (32 - sh)) | (b >> sh)) & 0xFFFF
