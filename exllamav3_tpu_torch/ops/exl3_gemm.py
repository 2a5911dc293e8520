"""EXL3 linear served straight from the packed trellis
(counterpart of exllamav3_tpu/ops/exl3_gemm.py).

y = ((x * suh) @ Hk) @ W_inner @ Hn * svh, with W_inner decoded from the
K-bit trellis words inside the kernel (csrc/exl3_gemm.cu), so a weight costs
K/8 bytes of device memory and of traffic. The Hadamards and sign vectors
stay outside the kernel, as plain torch. `words` keeps the JAX package's
layout (tk, K, tn*8) int32, so a parameter dict carries across unchanged;
the JAX kernel's permuted row and column orders and its 2^112 output scale
are artefacts of the TPU and have no counterpart here.

The kernel takes any number of rows: a block covers BLOCK_ROWS of them
and further rows run as further blocks that decode the weights again. So
`exl3_matmul` sends every CUDA tensor through the kernel, where the JAX
dispatch leaves its kernel above its FUSED_MAX_ROWS for reconstruct + matmul.
On the CPU the plain version serves every row count: the reconstruct
reference, bf16 operands and f32 sums, which both sides of the JAX dispatch
compute.
"""
from __future__ import annotations

import numpy as np
import torch

from ..quant.codebook import CB_3INST
from ..quant.hadamard import had_right
from ..quant.reconstruct import exl3_matmul_ref, reconstruct_inner
from .build import check_aligned, check_launch, library

BLOCK_ROWS = 128      # rows one block of the kernel covers (BM in the source)
BLOCKS_WANTED = 264    # in flight at decode sizes: two per SM of an H100


def trellis_to_words(trellis: torch.Tensor) -> torch.Tensor:
    """(tk, tn, 16K) int16 file halfwords -> kernel layout (tk, K, tn*8) int32,
    on the tensor's device: stream word S[g*K + wi] of tile (kt, nt) lands at
    [kt, wi, nt*8 + g]."""
    u = trellis.to(torch.int64) & 0xFFFF
    w = (u[..., 1::2] << 16) | u[..., 0::2]          # (tk, tn, 8K) in 0..2^32-1
    w = ((w ^ 0x80000000) - 0x80000000).to(torch.int32)
    tk, tn, nw = w.shape
    K = nw // 8                                      # (kt, nt, g, wi) -> (kt, wi, nt, g)
    return w.reshape(tk, tn, 8, K).permute(0, 3, 1, 2).reshape(tk, K, tn * 8).contiguous()


def prepare_trellis_words(trellis: np.ndarray) -> np.ndarray:
    """trellis_to_words on a numpy array (the JAX package's load-time name)."""
    return trellis_to_words(torch.from_numpy(np.ascontiguousarray(trellis))).numpy()


def words_to_trellis(words: torch.Tensor) -> torch.Tensor:
    """Inverse of prepare_trellis_words: (tk, K, tn*8) int32 -> (tk, tn, 16K)
    int16 file halfwords."""
    tk, K, ln = words.shape
    tn = ln // 8
    w = words.to(torch.int64) & 0xFFFFFFFF
    w = w.reshape(tk, K, tn, 8).permute(0, 2, 3, 1).reshape(tk, tn, 8 * K)
    halves = torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(tk, tn, 16 * K)
    return ((halves ^ 0x8000) - 0x8000).to(torch.int16)


def exl3_gemm_plain(xh: torch.Tensor, words: torch.Tensor, K: int, cb: int) -> torch.Tensor:
    """The kernel's function in plain torch: xh (m, k) bf16 times W_inner
    decoded to bf16, f32 sums. (m, n) f32."""
    w = reconstruct_inner(words_to_trellis(words), K, cb, dtype=torch.bfloat16)
    return xh.float() @ w.float()


def split_count(m: int, k: int, n: int) -> int:
    """k splits of the kernel's grid: enough blocks to fill the card at
    decode sizes, no split left without a 128-wide k step."""
    steps = k // 128
    blocks = (n // 128) * -(-m // BLOCK_ROWS)
    want = min(steps, max(1, -(-BLOCKS_WANTED // blocks)))
    per = -(-steps // want)
    return -(-steps // per)


def exl3_gemm_kernel(xh: torch.Tensor, words: torch.Tensor, K: int, cb: int) -> torch.Tensor:
    """Launch csrc/exl3_gemm.cu: xh (m, k) bf16, words (k/16, K, n/16*8)
    int32 -> (m, n) f32. k and n are multiples of 128, K in 1..8."""
    if not (xh.is_cuda and words.is_cuda and xh.device == words.device):
        raise ValueError("exl3_gemm_kernel: xh and words must be on one CUDA device")
    if xh.dtype != torch.bfloat16 or words.dtype != torch.int32:
        raise TypeError("exl3_gemm_kernel: expected bf16 xh and int32 words")
    if xh.dim() != 2 or words.dim() != 3:
        raise ValueError("exl3_gemm_kernel: expected xh (m, k) and words (k/16, K, n/2)")
    m, k = xh.shape
    tk, kw, ln = words.shape
    n = ln * 2
    if (m < 1 or kw != K or not 1 <= K <= 8 or cb not in (0, 1, 2) or tk * 16 != k
            or k % 128 or n % 128):
        raise ValueError(f"exl3_gemm_kernel: unsupported shapes xh {tuple(xh.shape)}, "
                         f"words {tuple(words.shape)}, K={K}, cb={cb}")
    if not (xh.is_contiguous() and words.is_contiguous()):
        raise ValueError("exl3_gemm_kernel: tensors must be contiguous")
    check_aligned("exl3_gemm_kernel", xh, words)
    splits = split_count(m, k, n)
    out = torch.empty((m, n), dtype=torch.float32, device=xh.device)
    scratch = (torch.empty((splits, m, n), dtype=torch.float32, device=xh.device)
               if splits > 1 else None)
    err = library().exl3_gemm(
        xh.data_ptr(), words.data_ptr(), out.data_ptr(),
        scratch.data_ptr() if scratch is not None else None, m, k, n, K, cb, splits,
        torch.cuda.current_stream(xh.device).cuda_stream)
    check_launch("exl3_gemm", err)
    exl3_gemm_kernel.launches += 1
    return out


exl3_gemm_kernel.launches = 0


def exl3_matmul_plain(x, words, suh, svh, K: int, cb: int = CB_3INST, bias=None,
                      out_dtype=None) -> torch.Tensor:
    """The full linear in plain torch: the reconstruct reference on the
    file layout of `words`."""
    return exl3_matmul_ref(x, words_to_trellis(words), suh, svh, K, cb, bias=bias,
                           out_dtype=out_dtype)


def exl3_matmul_fused(x, words, suh, svh, K: int, cb: int = CB_3INST, bias=None,
                      out_dtype=None) -> torch.Tensor:
    """The full linear through the kernel. x (..., k) on the card."""
    out_dtype = out_dtype or x.dtype
    k = x.shape[-1]
    n = words.shape[2] * 2
    x2 = x.reshape(-1, k)
    xh = had_right(x2.float(), scale_pre=suh).to(torch.bfloat16)
    y = had_right(exl3_gemm_kernel(xh, words, K, cb), scale_post=svh)
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.reshape(*x.shape[:-1], n).to(out_dtype)


def exl3_matmul(x, words, suh, svh, K: int, cb: int = CB_3INST, bias=None,
                out_dtype=None) -> torch.Tensor:
    """Dispatch. CUDA tensors go through the kernel at any row count; CPU
    tensors through the plain version (decode-sized and prefill-sized inputs
    share its arithmetic: bf16 operands, f32 sums)."""
    fn = exl3_matmul_plain if x.device.type == "cpu" else exl3_matmul_fused
    return fn(x, words, suh, svh, K, cb, bias=bias, out_dtype=out_dtype)
