"""Reconstruct dense weights from packed EXL3 tensors in torch
(counterpart of exllamav3_tpu/quant/reconstruct.py).

W = diag(suh) . Hk . W_inner . Hn . diag(svh), Hk/Hn blockwise 128-point
Hadamards scaled by 1/sqrt(128); W_inner[16*tk + r, 16*tn + c] is the decoded
code at tile (tk, tn), row-major (r, c). Everything runs on the device of the
trellis tensor, in float32.
"""
from __future__ import annotations

import torch

from .codebook import CB_3INST, CB_MCG, CB_MUL1, decode
from .hadamard import had_left, had_right
from .trellis import tile_perm_inverse, unpack_trellis


def codebook_id(mcg: bool = False, mul1: bool = False) -> int:
    if mcg:
        return CB_MCG
    if mul1:
        return CB_MUL1
    return CB_3INST


def reconstruct_inner(trellis: torch.Tensor, K: int, cb: int = CB_3INST,
                      dtype=torch.float32) -> torch.Tensor:
    """trellis (tiles_k, tiles_n, 16K) int16 -> W_inner (k, n) `dtype`."""
    tk, tn, pw = trellis.shape
    assert pw == 16 * K
    codes = unpack_trellis(trellis, K)                  # (tk, tn, 256) seq order
    vals = decode(codes, cb, dtype=dtype)
    tiles = vals[..., tile_perm_inverse().to(trellis.device)].reshape(tk, tn, 16, 16)
    return tiles.permute(0, 2, 1, 3).reshape(tk * 16, tn * 16)


def reconstruct_full(trellis: torch.Tensor, suh: torch.Tensor, svh: torch.Tensor,
                     K: int, cb: int = CB_3INST, dtype=torch.float32) -> torch.Tensor:
    """Original-basis weight (k, n), computed in f32 and returned as `dtype`."""
    w = reconstruct_inner(trellis, K, cb, dtype=torch.float32)
    w = had_left(w)
    w = w * suh.to(torch.float32)[:, None]
    w = had_right(w)
    w = w * svh.to(torch.float32)[None, :]
    return w.to(dtype)


def exl3_matmul_ref(x: torch.Tensor, trellis: torch.Tensor, suh: torch.Tensor,
                    svh: torch.Tensor, K: int, cb: int = CB_3INST,
                    bias: torch.Tensor | None = None, out_dtype=None) -> torch.Tensor:
    """y = ((x*suh) @ Hk) @ W_inner @ Hn * svh + bias, W_inner decoded per
    call (the `reconstruct` linear mode). bf16 operands, f32 accumulation."""
    out_dtype = out_dtype or x.dtype
    xh = had_right(x, scale_pre=suh)
    w = reconstruct_inner(trellis, K, cb, dtype=torch.bfloat16)
    y = xh.to(torch.bfloat16).float() @ w.float()
    y = had_right(y, scale_post=svh)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(out_dtype)
