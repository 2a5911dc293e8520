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


# codes decoded at a time: the unpack and the decode hold several int64 copies
# of them, which a 151936-row head would otherwise take by the gigabyte
_DECODE_CODES = 1 << 23


def reconstruct_inner(trellis: torch.Tensor, K: int, cb: int = CB_3INST,
                      dtype=torch.float32) -> torch.Tensor:
    """trellis (tiles_k, tiles_n, 16K) int16 -> W_inner (k, n) `dtype`,
    decoded a band of tile rows at a time."""
    tk, tn, pw = trellis.shape
    assert pw == 16 * K
    perm = tile_perm_inverse().to(trellis.device)
    out = torch.empty((tk * 16, tn * 16), dtype=dtype, device=trellis.device)
    step = max(1, _DECODE_CODES // (tn * 256))
    for r0 in range(0, tk, step):
        codes = unpack_trellis(trellis[r0:r0 + step], K)   # (rows, tn, 256) seq order
        vals = decode(codes, cb, dtype=dtype)
        tiles = vals[..., perm].reshape(-1, tn, 16, 16)
        out[r0 * 16:(r0 + step) * 16] = tiles.permute(0, 2, 1, 3).reshape(-1, tn * 16)
    return out


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
