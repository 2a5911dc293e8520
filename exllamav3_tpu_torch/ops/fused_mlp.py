"""Fused gate_up -> silu -> down decode MLP
(counterpart of exllamav3_tpu/ops/fused_mlp.py).

acc = sum over intermediate tiles of bf16(silu(x@Wg*sg) * (x@Wu*su)) @ Wd;
the caller applies the down scale and bias. On a CUDA tensor the wrapper
launches csrc/fused_mlp.cu; on a CPU tensor it runs the plain version.
Only silu is ported; gelu, relu2 and the clamp wait.
"""
from __future__ import annotations

import torch

from .build import check_aligned, check_launch, library

MAX_ROWS = 16
TILE_I = 64  # intermediate columns per block in the kernel


def fused_mlp_int8_plain(x: torch.Tensor, gu_q: torch.Tensor, gu_scale: torch.Tensor,
                         d_q: torch.Tensor) -> torch.Tensor:
    """x (m, h); gu_q (h, 2i) int8 [gate | up]; gu_scale (2i,) f32; d_q (i, h)
    int8 -> (m, h) f32 before the down scale."""
    inter = d_q.shape[0]
    gu = (x.to(torch.bfloat16).float() @ gu_q.float()) * gu_scale[None, :]
    g, u = gu[:, :inter], gu[:, inter:]
    a = (g * torch.sigmoid(g) * u).to(torch.bfloat16)
    return a.float() @ d_q.float()


def fused_mlp_int8_kernel(x: torch.Tensor, gu_q: torch.Tensor, gu_scale: torch.Tensor,
                          d_q: torch.Tensor) -> torch.Tensor:
    """Launch csrc/fused_mlp.cu: x (m <= 16, h) bf16, gu_q (h, 2i) int8,
    gu_scale (2i,) f32, d_q (i, h) int8; h % 256 == 0, i % 128 == 0."""
    m, h = x.shape
    inter = d_q.shape[0]
    tensors = (x, gu_q, gu_scale, d_q)
    if not all(t.is_cuda and t.device == x.device for t in tensors):
        raise ValueError("fused_mlp_int8_kernel: all tensors must be on one CUDA device")
    if (x.dtype, gu_q.dtype, gu_scale.dtype, d_q.dtype) != (
            torch.bfloat16, torch.int8, torch.float32, torch.int8):
        raise TypeError("fused_mlp_int8_kernel: expected bf16, int8, f32, int8")
    if (not 0 < m <= MAX_ROWS or gu_q.shape != (h, 2 * inter) or gu_scale.shape != (2 * inter,)
            or d_q.shape != (inter, h) or h % 256 or inter % 128):
        raise ValueError(f"fused_mlp_int8_kernel: shapes x {tuple(x.shape)}, "
                         f"gu {tuple(gu_q.shape)}, d {tuple(d_q.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_mlp_int8_kernel: tensors must be contiguous")
    check_aligned("fused_mlp_int8_kernel", *tensors)
    partial = torch.empty((inter // TILE_I, m, h), dtype=torch.float32, device=x.device)
    out = torch.empty((m, h), dtype=torch.float32, device=x.device)
    err = library().exl3_fused_mlp(
        x.data_ptr(), gu_q.data_ptr(), gu_scale.data_ptr(), d_q.data_ptr(),
        partial.data_ptr(), out.data_ptr(), m, h, inter,
        torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("exl3_fused_mlp", err)
    fused_mlp_int8_kernel.launches += 1
    return out


fused_mlp_int8_kernel.launches = 0


def fused_mlp_int8(x, gu_q, gu_scale, d_q, d_scale, d_bias=None):
    """x (..., h) -> (..., h) f32, down scale and bias applied."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if x.device.type == "cpu":
        y = fused_mlp_int8_plain(x2, gu_q, gu_scale, d_q)
    else:
        y = fused_mlp_int8_kernel(x2.to(torch.bfloat16).contiguous(), gu_q, gu_scale, d_q)
    y = y * d_scale[None, :]
    if d_bias is not None:
        y = y + d_bias
    return y.reshape(shape)


def fused_mlp_eligible(mlp, params: dict, T: int) -> bool:
    """The decode fast path: fused int8 gate_up, int8 down, silu and at most
    16 rows."""
    if T > MAX_ROWS or mlp.activation != "silu":
        return False
    p = params.get(mlp.key, {})
    pd = params.get(mlp.down.key, {})
    if "gate_up_q" not in p or "weight_q" not in pd:
        return False
    h, inter = mlp.down.out_features, mlp.down.in_features
    return h % 256 == 0 and inter % 128 == 0
