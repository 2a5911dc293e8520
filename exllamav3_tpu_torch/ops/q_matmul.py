"""int8 dequant matmul: y = (x @ W_q) * scale[col]
(counterpart of exllamav3_tpu/ops/q_matmul.py::int8_matmul).

On a CUDA tensor the wrapper launches the hand-written kernel in
csrc/int8_matmul.cu, which reads the int8 weights once (1 byte/weight) and
converts them to bf16 on chip; on a CPU tensor it runs the plain version.
The int4 and int-B kernels are not ported yet.
"""
from __future__ import annotations

import torch

from .build import check_aligned, check_launch, library

SMALL_M = 16  # rows up to this take the decode tiling (16 x 128 x 128)


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x (m, k); w_q (k, n) int8; scale (n,) f32 -> (m, n) f32: bf16 x,
    bf16-exact weights, f32 accumulation."""
    y = x.to(torch.bfloat16).float() @ w_q.float()
    return y * scale[None, :].to(torch.float32)


def _split_k(tiles: int, k_tiles: int, device) -> int:
    """Split the k loop until the grid has about two blocks per SM, keeping
    at least two k tiles per split."""
    target = 2 * torch.cuda.get_device_properties(device).multi_processor_count
    s = 1
    while tiles * s < target and k_tiles % (2 * s) == 0 and k_tiles // (2 * s) >= 2:
        s *= 2
    return s


def int8_matmul_kernel(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Launch csrc/int8_matmul.cu: x (m, k) bf16, w_q (k, n) int8, scale (n,)
    f32, all contiguous on one CUDA device; k % 128 == 0, n % 128 == 0."""
    m, k = x.shape
    n = w_q.shape[1]
    if not (x.is_cuda and w_q.device == x.device and scale.device == x.device):
        raise ValueError("int8_matmul_kernel: all tensors must be on one CUDA device")
    if x.dtype != torch.bfloat16 or w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"int8_matmul_kernel: dtypes {x.dtype}, {w_q.dtype}, {scale.dtype}")
    if w_q.shape[0] != k or scale.shape != (n,) or k % 128 or n % 128 or m == 0:
        raise ValueError(f"int8_matmul_kernel: shapes x {tuple(x.shape)}, w {tuple(w_q.shape)}")
    if not (x.is_contiguous() and w_q.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int8_matmul_kernel: tensors must be contiguous")
    check_aligned("int8_matmul_kernel", x, w_q, scale)
    bm, bk = (16, 128) if m <= SMALL_M else (128, 32)
    splits = _split_k((n // 128) * -(-m // bm), k // bk, x.device)
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    ws = torch.empty((splits, m, n), dtype=torch.float32, device=x.device) if splits > 1 else y
    err = library().exl3_int8_matmul(
        x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), y.data_ptr(), ws.data_ptr(),
        m, k, n, splits, torch.cuda.current_stream(x.device).cuda_stream)
    check_launch("exl3_int8_matmul", err)
    int8_matmul_kernel.launches += 1
    return y


int8_matmul_kernel.launches = 0


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, bias=None) -> torch.Tensor:
    """x (..., k) -> (..., n) f32. CUDA tensors go through the kernel, CPU
    tensors through the plain version."""
    shape = x.shape
    n = w_q.shape[1]
    x2 = x.reshape(-1, shape[-1])
    if x.device.type == "cpu":
        y = int8_matmul_plain(x2, w_q, scale)
    else:
        y = int8_matmul_kernel(x2.to(torch.bfloat16).contiguous(), w_q, scale)
    if bias is not None:
        y = y + bias
    return y.reshape(*shape[:-1], n)
